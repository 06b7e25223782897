#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: `python3 chip_smoke.py`.

Phases, each fatal on failure:
  1. the card's name and power limit; build the seven CUDA kernels from
     keypoint_bench_tpu_torch/csrc with nvcc, in parallel, and print what
     `-Xptxas -v` says of kernels B, D, E, F and C (registers, shared
     memory, spills);
  2. the ALIKE-t and SuperPoint forwards on the card vs the CPU at 128^2
     (atol 1e-4, f32 with TF32 off on both);
  3. kernel A (NMS fixpoint) vs its plain twin on real ALIKE-t score maps
     at 512^2, a tie-heavy bf16 map and a signed map: bit equality, one
     launch a call, the rounds each map ran; its cooperative grid, and the
     tiles it recomputed per round against the plain run's changed tile
     neighbourhoods; timed beside two bounds (full rounds, changed tiles);
  4. kernel B (sparse sampler) vs its plain twin on real branch features
     at 512^2, K=1000, original and y-sorted keypoint order, and on random
     features whose last branch is 3 x 3 or 2 x 2: max abs error <= 1e-5;
     timed in both orders (CUDA events) beside the plain twin, the bound
     of the distinct values and the bound of the 32-byte sectors a kernel
     reading the channel-major layout must move;
  5. the ALIKE-t path, `extract_match` at 512^2, 16 pairs, nms 6, border
     8, top_k 1000, max_distance 5, with the launch counts reset just
     before it (kernel A exactly twice, one launch a detection batch):
     keypoints and masks equal to the same pipeline through the plain
     twins, match count within 0.5% of the valid keypoints; then
     timed (median of 7 windows) with a per-stage breakdown, and, after
     the timings, kernel B's device time of a call from the profiler;
  6. synthetic repeatability (configs/repeatability_synthetic.yaml, 4
     pairs at 512^2) through the port's runner, equal to the plain-twin run;
  7. kernel D (nearest neighbours) vs its plain twin on real SuperPoint
     (D = 256) and ALIKE-t (D = 64, the main path's) descriptors at
     K = 1000 and on random unit descriptors at K = 4096 (D = 256), with
     invalid rows and columns (one penalty column each): indices equal
     except near ties (the two candidates' distances within 1e-5 of
     |a|^2 + |b|^2), distances within 1e-4 of it; bit-equal on integer
     descriptors; each of the three timed in turns with the library
     yardstick (baddbmm, then both minima with their indices), beside
     the plain twin, the bound and the device time of a call from the
     profiler;
  8. kernel E (masked attention) vs its plain twin within 1e-5 absolute
     and relative: 8 pairs x 2 sides x 4 heads at K = 1000 for both scales,
     all keys invalid (finite and uniform), n != m off the tile size; timed
     in turns with scaled_dot_product_attention (kernel, library, library,
     kernel);
  9. `superpoint_mha_step` at 512^2, nms 6, border 8, top_k 1000,
     max_distance 5, n_hyp 512 with brute force (16 pairs) and with
     LightGlue (8 pairs), launch counts reset just before each: matches
     and MHA hits against the plain-twin step on the same generator seed
     (0.5% match-count rule, differences in hits recorded), LightGlue's
     2-layer scores against the plain twins on the step's descriptors;
     then timed (median of 7 windows) with a per-stage breakdown, and one
     step under torch.profiler for the device's busy time and top kernels;
 10. the port's Evaluator: MHA with SuperPoint + light_glue on 4 synthetic
     pairs at 512^2 from golden weights staged under output/, equal to the
     plain-twin run;
 11. kernel E timed alone at K = 4096, in turns with the library call,
     whose device kernels are named from a profiled call;
 12. kernel F (one LK level) vs the plain `_lk_level` on 8 pairs of
     consecutive synthetic-sequence frames at 512^2, K = 1000: per level
     from the same start at 8 iterations, win 21 and win 3, on ALIKE-t's
     keypoints and on points within 3 px of the borders and corners (max
     abs error <= 5e-3 px; at win 3 on the border set, where systems are
     near-singular, at most 0.5% of the points beyond it); then the full
     protocol (3 levels x 40
     iterations, distance 10, same angles): at least 99% of the points
     within 1e-2 px of the plain run, the rest printed with their det;
     then each level timed from the starts the protocol gives it, in turns
     with the plain version, with the share of iterations that loaded a
     window;
 13. `lk_fundamental_step` (ALIKE-t -> detection -> LK 21 / 3 / 40 / 10 ->
     epipolar error) on those 8 pairs, launch counts reset just before it:
     keypoints equal to the plain-twin step, per-pair error within 1e-3
     relative, hit count within 0.5% of the valid keypoints; then timed
     (median of 7 windows) in frames/s with a per-stage breakdown and one
     step under torch.profiler;
 14. kernel C (the per-chunk peel) vs its plain version on ALIKE-t's NMS'd
     maps [16,512,512], a tie-heavy and a sparse map, maps with NaN chunks
     and with -0.0 beside +0.0: values equal under == (NaN matching NaN),
     indices equal, (NaN, W) in every round of a NaN chunk; the rounds
     per chunk the maps need, reckoned from the plain peel's candidates;
     then `detection_batch_fused` vs `detection_batch` on the same score
     maps, launch counts reset just before it: keypoints and masks equal,
     the full-sort guard taken on the tie-heavy maps and not on the real
     ones; kernel C timed in turns with its library yardstick, torch.topk
     of every 128-column chunk of the same border-masked maps (values
     equal to C's), and the device time of a call of each from the
     profiler; the two detection paths timed in turns;
 15. the port's Evaluator: FundamentalMatrix with optical_flow on 5
     synthetic-sequence frames at 512^2, per pair and pipelined, against
     the plain-twin runs on the same seed;
 16. XFeat's forward joins phase 2's card-vs-CPU check; the AUC path
     (bench.py:221-311): 8 synthetic SE3 pairs at 512^2 with 2400 blobs,
     then `xfeat_auc_step` (XFeat x2 -> detection (kernel A) ->
     descriptors at stride 8 -> LightGlue with the 64 -> 256 input
     projection (kernel E) -> essential RANSAC with 4096 hypotheses ->
     recoverPose -> pose error), launch counts reset just before it
     (kernel A twice, kernel E 18 times); A bit-equal to fast_nms and E
     within 1e-5 of max(1, max |v|) of fused_attention on the very calls
     the step made (|v| reaches ~120 in the deep layers);
     keypoints equal to the plain-twin step on the same generator seed,
     errors within 1e-3 degrees; timed (median of 7 windows) in pairs/s
     with a per-stage breakdown and one step under torch.profiler;
 17. RANSAC-E + recoverPose on the card against the same functions on the
     CPU with the same minimal samples, on the warp_se3 ground-truth
     correspondences of the step's keypoints: in float32 ok equal, inlier
     counts within 0.5% and pose errors (evaluated in float64) within 0.1
     degrees, the two SVD routes' float32 spread on these normal
     equations; in float64 counts equal and pose errors within 1e-3
     degrees; the stage and
     its parts timed (sampling, 8-point solves beside the float32 SVD
     route they replace, essential projections, Sampson matrix), and the
     host synchronizations it makes counted;
 18. the port's Evaluator: AUC with ALIKE-t + brute force (kernels A and
     D) on 4 SE3 pairs at 512^2: median pose error < 10 degrees, AUC@20 >
     0.3, per-pair errors within 1e-3 of the plain-twin run; SE3
     repeatability on the same pairs > 0.1;
 19. the VO path's data (bench.py:366-385): 32 frames of the synthetic
     plane sequence at 512^2 as uint8, and 8 frames of the splat sequence;
 20. `vo_step` on the 32 frames (Alike_s2d -> detection in chunks of 8
     (kernels A and B) -> mutual NN over the 32 pairs (kernel D) ->
     RANSAC-E with 4096 hypotheses + recoverPose -> pose chain; with BA:
     chain_tracks -> triangulation -> gate -> 8 LM / Schur iterations),
     launch counts reset just before it (A and B 4 times, D once); A
     bit-equal, B within 1e-5 and D's indices equal except near ties on
     the very calls the step made; keypoints equal and matches within
     0.5% of the plain-twin step on the same seed (positions and BA equal
     where the matches are); peak memory; timed (median of 7 windows) in
     frames/s without and with BA, its stages, one step of each under
     torch.profiler, the host syncs of one ba_solve (none allowed) and of
     one step; the BA window's C, P and N;
 21. `ba_solve` on the card against the CPU on the step's window, in
     float32 (mean error within 1e-3 px) and float64 (1e-6 px), poses
     compared after the scale about camera 0 that a monocular window
     leaves free (`gauge_gap`; rotations and camera centres within 1e-3
     and 1e-6, points within 1e-6 of max(1, |X|) in float64 and printed
     in float32), the LM accept patterns printed and equal in float64; a float32 flip (near-equal
     costs) is reported, with the gaps it leaves;
 22. the port's Evaluator: `visual_odometer` on the 8 splat frames,
     pipelined with BA (configs/vo_synthetic.yaml; A, B, D) and pair by
     pair with optical_flow at LK distance 0 (A and F, 3 launches a
     pair), each against its plain-twin run: positions within 1e-3 of the
     trajectory's length; the median ATE over the generator seeds 0-4
     below twice the JAX runner's median over the same seeds' keys on the
     CPU (`JAX_CPU_ATE`; one draw's ATE spreads several-fold across
     seeds); BA: error falls, over 100 tracks, over 95% of the points in
     front of camera 0;
 24. the detector family's forwards (EdgePoint, GoodPoint, LETNet, r2d2,
     DISK, sfd2, D2Net, KeyNet, Harris, ORB, SIFT) on the card against
     the port's CPU path, at 64^2 on the golden inputs and at 512^2 on a
     texture: within 1e-4 of each map's largest value, NaNs at the same
     places; sfd2's stability class may flip only where the top two
     logits lie within 1e-5 of the largest |logit| (the flips counted,
     those pixels set aside);
     the 8 learned models against their golden fixtures with
     tests/test_models.py's tolerances;
 25. `dense_extract_match` (bench.py:626-640's dense pair step, batched)
     for the seven descriptor models on 4 uint8 texture pairs at 512^2,
     and `dense_detect` of both sides for the four detectors, launch
     counts reset just before each (kernel A twice; D once, 2 launches,
     with descriptors); A bit-equal
     (NaN bits included) and D's indices equal except near ties on the
     step's own calls; keypoints bit-equal to the plain-twin step, a
     match row parted only where D's pick is a near tie; timed (median
     of 7 windows) in pairs/s and frames/s with peak memory and stages
     (forward, detection, sampling, D); kernel D on the LETNet (D = 4)
     and D2Net (D = 513) steps' inputs timed in turns with baddbmm +
     both minima, beside the plain twin, the bound and its device time;
 26. the sweep: `run_sweep` on configs/sweep_repeatability.yaml's base (4
     pairs at 512^2) over its seven models, then DISK, sfd2 and D2Net
     from staged golden weights, ORB and SIFT: each repeatability equal
     to the plain-twin sweep's, printed beside the JAX package's on the
     CPU (`JAX_CPU_SWEEP`, tools/sweep_cpu_reference.py);
 27. the port's Evaluator: FundamentalMatrix with LETNet + optical_flow
     (kernel F on its 3-channel descriptor maps, A) on 5 frames at 512^2,
     per pair and pipelined: F's launches, F within 1e-2 px of
     `_lk_level` on 99% of the points of its own calls, the result
     against the plain-twin run as in phase 15;
 28. bf16 mode (bench.py's default precision; `bf16_phases`): every
     weighted model's bf16 forward on the card against the CPU at 64^2,
     within `BF16_TOL`'s bf16 ulps of each map's largest value (a cap, and
     a share of the values beyond 4 ulps; sfd2's NaN positions may part
     on 1% of the pixels);
 29. kernel B's bf16 instantiation on ALIKE-t's bf16 branch maps (16
     maps, K = 1000, original and y-sorted order) against the plain bf16
     sampler within 1e-5 of the largest sample; timed in turns with the
     f32 instantiation on the same values, its device time, the bounds of
     the distinct values and of the 32-byte sectors at 2 bytes a value;
 30. every step in bf16 at 512^2 (the params' dtype selects the mode),
     launch counts reset just before each and read just after:
     `extract_match` (16 pairs; A twice, B-bf16 twice, D once on the
     exact f32 upcast of the bf16 descriptors, no f32 B),
     `superpoint_mha_step` (brute force, 16 pairs), `dense_extract_match`
     for r2d2, DISK and D2Net (4 pairs), `lk_fundamental_step` (8 pairs),
     `xfeat_auc_step` (8 pairs), the AUC runner (ALIKE-t + brute force, 4
     SE3 pairs) and `vo_step` (32 frames; A and B-bf16 a chunk, D once);
     each against its plain-twin run (keypoints equal, match counts
     within 0.5% of the valid keypoints) and against its f32 run:
     repeatability on the homography pairs within 0.02 and its mean
     error within 0.05 px (tests/test_precision.py's bounds); keypoint
     sets (Jaccard >= 0.7) for the LK, AUC and VO steps; the LK step's
     mean epipolar error within 0.05 px; the AUC step's match count
     within 15% (its randomized LightGlue matches nothing, so its poses
     fail in both runs); the AUC runner's inlier count within 15%, with
     the f32 runner's own gates; the VO step's inlier count within 15%
     and its ATE under twice the f32 step's (the VO runner's rule
     against the JAX runner); each
     timed in turns with its f32 run in the same call (windows of both),
     with each one's device busy time, host window, device activities
     and top kernels from the profiler;
 31. the runner on configs/repeatability_synthetic.yaml with precision
     bfloat16 set in code: equal to its plain-twin run and within 0.02 /
     0.05 of phase 6's f32 run;
 32. an `xfeat_auc_step` JSON line, a `vo_step` JSON line, a
     `dense_extract_match` JSON line, a `bf16` JSON line, a `file_backed`
     JSON line, a JSON line of phases 41-44 (`adaptive_lightglue`,
     `five_point`, `tracking_error`), the card's name and power limit, a
     `kernels` JSON line and, last, the device JSON line (after phases
     33-44).
The file-backed datasets (`file_phases`), before phase 32's lines; each
writes its tree in a temporary directory (PNGs with this script's own
zlib encoder, `png_bytes`, every row filter in turn) and runs a shipped
config on it through the port's CLI, with launch counts reset just before
and read just after, against its plain-twin run, then run again warm
for its time a pair and the share of it its dataset's loads took:
 33. the native loader (runtime/loader.cpp, built with g++): P5 and P6
     files with comment lines and odd sizes through `load_pnm_resized`
     and `NativePrefetcher`, against the numpy decode + `resize_linear`
     within `loader_tol`; images/s at 512^2 from 700 x 1000 PPMs;
 34. HPatches: 3 sequences of 6 PPMs (800 x 600, 1000 x 700), viewpoint
     homographies H_1_k in the original pixel frame and one illumination
     sequence; configs/repeatability_hpatches.yaml (kernel A once an
     image) and configs/mha_hpatches.yaml (A, and D once a pair): per-pair
     results equal to the plain-twin run, repeatability and MHA@3 within
     0.02 of the JAX package's CPU run on the same tree (`JAX_CPU_FILE`,
     tools/file_configs_cpu_reference.py); ms a pair and the loader's
     share;
 35. resume: configs/repeatability_hpatches.yaml over a sub-tree of its
     first 3 pairs (a journal of 3 records), then over the whole tree
     with `resume: true`: equal to the uncut run, with forward calls (and
     kernel A launches) for the remaining pairs only;
 36. KITTI: 8 gray PNG frames at 376 x 1241 of the splat scene through
     KITTI's intrinsics with a pose file; configs/vo_kitti.yaml
     (optical_flow: A, and F at C = 3 on the 352 x 1216 crop): at LK
     jitter distance 0, positions within 1e-3 of the trajectory's length
     of the plain-twin run (as phase 22); as shipped, the median ATE over
     seeds 0-4 below twice the JAX package's CPU median;
 37. TartanAir: 5 RGB PNG frames at 480 x 640 with TUM-format ground
     truth; configs/fund_tartanair.yaml against the plain twin as in
     phase 15;
 38. image pairs: 4 PNG pairs at 480 x 640 and their list file;
     configs/long_term.yaml (FundamentalMatrixRansac, brute force: A, D):
     the inlier ratio within 0.005 of the plain twin's;
 39. MegaDepth: the committed HDF5 fixtures that h5py wrote
     (tests/data/h5/*.h5: chunked, filtered, libver "latest") read by
     datasets/h5.py equal to the .npy arrays saved beside them; 2 pairs
     at 1066 x 1600 (JPEG, and h5 files that `write_h5` writes, as the
     card has no h5py), configs/auc_megadepth.yaml, per-pair errors within
     1e-3 degrees of the plain twin's, ms a pair and the loader's share (a
     missing PIL fails the phase); EuRoC's loader and IMU preintegration
     where cv2 imports, otherwise one line says it is missing;
 40. kernels A, B, D and F at these shapes: A bit-equal on the runs' own
     score maps ([1,512,512], [1,352,1216], [1,480,640], MegaDepth's
     [1,1056,1600]), B at batch 1
     on ALIKE-t's branches of those sizes (within 1e-5), D on the MHA,
     image-pair and MegaDepth runs' own calls (`check_nn`), F on the
     KITTI and TartanAir runs' own calls (99% of the points within 1e-2
     px); each timed (events back to back, and the profiler's device time
     of a call) beside its plain version and its bound, D beside baddbmm +
     both minima.
Adaptive LightGlue, the five-point solver and VisualizeTrackingError,
after phase 40, each run with the launch counts reset just before it and
read just after:
 41. adaptive LightGlue (`models/lightglue_adaptive.py`) on SuperPoint's
     keypoints and descriptors of the first 8 homography pairs at 512^2,
     K = 1000, one pair at a time: in the runner's mode (depth 0.95,
     width 0.99; the randomized weights stop at layer 4) and in a pruning
     mode (no early stop, descriptors at the golden fixture's norm 16, so
     the masks shrink over the layers down to empty sides); each pair on
     the card against its plain twin: layers run, every layer's keep
     counts and the matches equal, or parted only where a stop or keep
     decision lay within 1e-5 of its threshold (the smallest such margin
     printed); kernel E twice a layer, within 1e-5 of max(1, max |v|) of
     fused_attention on its own calls; the host reads of `stop`; the
     adaptive pair timed in turns with the fixed-depth pair, and kernel E
     on a pair's own calls timed in turns with
     scaled_dot_product_attention on the same masks, beside the plain
     twin and the bound of the valid queries and keys; then the MHA
     runner with `light_glue_params.adaptive` on 4 pairs against its
     plain twin;
 42. kernel E on an emptied side: the pruning run's calls whose mask
     leaves a slice no valid key (its rows uniform), and [2,4,1000,64]
     with side 0 all invalid, within 1e-5 of fused_attention;
 43. the five-point solver (`geometry/fivepoint.py`) on phase 17's
     ground-truth correspondences: the candidates of 64 fixed samples a
     pair, card against the CPU (the share of samples whose best valid
     candidate recovers the pose within 1 degree, over 75% and within 2%
     of each other, and the median gap of their poses within 0.1 degree,
     beside the CPU against itself on inputs moved by 1e-7);
     `ransac_essential_5pt_from_samples` over 512 samples a pair, card
     against the CPU: ok equal, inliers equal except at Sampson residuals
     within 1e-6 of the threshold; `estimate_pose_pair` with solver 5pt
     timed in turns with the 8-point path, its candidate stage and its
     host syncs; the AUC runner with solver 5pt (phase 18's ALIKE-t +
     brute force: XFeat has no LightGlue adapter in the runner) against
     its plain twin, with phase 18's gates;
 44. VisualizeTrackingError through the runner, ALIKE-t (on the frames)
     and LETNet (on its descriptor maps), 4 homography pairs at 512^2,
     configs/fund_synthetic.yaml's LK protocol: kernel A twice and F
     three times a pair, F starting from the warped points and held on
     its own calls (99% of the points within 1e-2 px); track_error
     against the plain twin within 1e-3 relative at LK distance 0 and
     within 1e-3 px at distance 10; ms a pair.
Loop closure, the pose graph, predict_positions and save_images, after
phase 44 (`loop_closure_phases`, `save_images_phases`), the launch counts
reset just before each path and read just after:
 45. the pose graph (ba/pose_graph.py): a 31-pose out-and-back chain with
     noisy odometry and 14 exact closures, `pgo_solve` (15 iterations)
     on the card against its CPU twin within 1e-4 of the trajectory's
     extent, no host sync inside; exact odometry leaves a residual under
     1e-5; ms on the card and the CPU;
 46. strong closures: tests/test_loop_closure.py's out-and-back splat
     sequence with 31 frames at 512^2, ALIKE-t at K = 1000 (kernels A
     and B), every frame pair at gap >= 4 (378) matched by one kernel D
     launch, equal to the per-pair loop on the card and to the CPU twin's
     closures; the pose-graph correction cuts the noisy chain's ATE below
     0.8x; detect_loop_closures timed against the per-pair loop, its host
     syncs counted; kernel D at the batched shape beside its plain
     version, baddbmm + minima and its bound;
 47. scaled closures: on the geometric fixture (the metric translation
     within 0.05, the rotation within 2 degrees), and with `images` on a
     9-frame parallax loop (return 0.3 to the side): the neighbour tracks
     through kernel F (held on its own calls, 99% within 1e-2 px), the
     closures equal to the CPU twin's under the same draws (samples from
     a CPU generator, fixed jitter angles), each inside the drift
     envelope; every parallax candidate's RANSAC-E from the same inputs
     and samples in float32 and float64 on both sides: the card's winning
     hypothesis scores, under the float64 CPU solve, within 0.5% of the
     matches of that solve's best, and the card's refits end within 0.5%
     of the float64 CPU refits from the same hypothesis;
 48. predict_positions on SuperPoint's coarse maps of a 512^2 pair
     ([64, 64, 256]): card against the CPU twin, positions within 1e-5,
     the score within 1e-4 (each side's gap to float64 printed);
 49. save_images on 2 pairs each of repeatability, MHA, AUC and the
     per-pair FundamentalMatrix (ALIKE-t + brute force at 512^2) on the
     card and on the CPU: the JAX runner's PNG names, pixel-equal wherever
     the drawn keypoints or matches are equal; save_metric_plot where
     matplotlib imports.
The parallel layer on the one card (`parallel_phases`), after phase 49;
each path at world 1 (a one-rank NCCL process group, whose collectives
run NCCL's code) and on 2 ranks that share the card over gloo (threads of
this process; gloo's send and recv take host memory, so the ring hop is
staged through the host), the launch counts reset just before each run
and read just after, kernels A, B, D and E held against their plain
versions on every rank's own calls, each timed with the collectives'
share of its time and the transfers that went through the host:
 50. `sharded_eval_step` (ALIKE-t dense: A, D; Alike_s2d sparse: A, B,
     D) on the 16 homography pairs at 512^2, K = 1000: world 1 bit-equal
     to the one-rank `batched_repeatability_step`, every rank of world 2
     bit-equal to it on the 8-pair blocks; the gap between the worlds
     printed (the forward runs on each rank's block);
 51. `sharded_mha_step`, SuperPoint + brute force, the same 16 pairs;
 52. `sharded_auc_step`, ALIKE-t + brute force on phase 16's 8 SE3 pairs,
     n_hyp 4096;
 53. the runner's batch paths (data_params.batch_size 4 over 6 pairs: a
     batch and a 2-pair ragged tail): repeatability, MHA and AUC
     (ALIKE-t + brute force), at world 1 and on 2 ranks, against
     the per-pair run: per-pair repeatability within 2e-3, MHA within one
     pair; AUC with pair i's RANSAC draws from seed i on both paths
     (`pair_indexed_draws`): the same failed pairs, at least half the
     pairs with equal inlier counts and their errors within 1 degree,
     every pair finite, mean inliers above 0.6 of the per-pair run's;
 54. `ba_solve_distributed` on phase 20's window: on the one-rank group
     equal to `lm_iterations`; on 2 ranks, card against CPU in float32
     and float64 after `gauge_gap` (phase 21's gates); `vo_step` with
     `refine_window(mesh)` on the one-rank group and on 2 ranks against
     the one-rank refinement (tests/test_vo_ba.py's gates: the same
     tracks, a refinement, the mean error within 5% and rotations within
     2e-3; the free scale printed); timed;
 55. `sharded_vo_pair_solves` on phase 20's 32 frames against
     `vo_step`'s pair poses on the same samples (ok equal, R and t within
     1e-4), kernel D held on its calls; timed;
 56. head-sharded LightGlue (D = 256, 4 heads, 9 layers, K = 1000, the
     golden weights, phase 9's first SuperPoint pair) over 2 and 4 model
     ranks against the dense forward: matches agree above 99%, mscores
     within 1e-3, the 2-layer log scores within 1e-4 of their norm;
     kernel E 18 launches a rank; timed against the dense forward.
The last modules of the JAX package (`sp_pp_phases`, after phase 56):
 57. ring attention, [4, 1000, 64] with a padded tail and the first 250
     keys masked (rank 0's whole chunk at 4 ranks), over a one-rank NCCL
     group and 2 and 4 gloo ranks on the card: within 1e-5 of the plain
     dense attention; ring hops and their host staging printed, timed;
 58. sequence-parallel LightGlue (D = 256, 4 heads, 9 layers, K = 1000,
     the golden weights, phase 56's pair) over 2 and 4 data ranks:
     matches equal to the dense forward's (kernel E, 18 launches), mscores
     within 2e-3, the 2-layer log scores within 1e-4 of their norm, no
     kernel E launch on the ring path; timed against the dense forward;
 59. the two-stage pipeline, ALIKE-t on config 1's 16 images at 512^2 in
     4 microbatches over 2 gloo ranks: `two_stage_pipeline` bit-equal to
     the sequential map, `pipeline_extract` within 1e-6 (masks equal) of
     `detection_batch` on the same forwards, kernel A once a microbatch,
     held on its calls; timed against data-parallel extraction on the
     same ranks, the bytes staged through the host printed (no speed
     gate);
 60. `export_model` of ALIKE-t at 512^2 reloaded and run within 1e-5 of
     the eager forward; `info --latency` (model_cost and latency) and a
     `trace` with its device kernels, beside the card's name and power
     limit;
 61. the runner with debug_nans on configs/repeatability_synthetic.yaml
     and on 4 MHA pairs (SuperPoint + light_glue): equal to the runs
     without it; a NaN planted in one pixel raises FloatingPointError.
The last entry points (`convert_demo_phases`, after phase 61):
 62. the reference's checkpoints of every SPECS entry, written from the
     repository's parameters in the upstream layout and nesting (one a
     git-LFS pointer, one absent), converted by the port's converter on
     this machine, which has no JAX: each npz bit-equal to its source,
     the skipped list the pointer's and the absent name, no JAX module
     loaded; the seconds printed;
 63. DISK + LightGlue MHA through the runner from phase 62's converted
     weights (DISK 128-d, the 128 -> 256 input_proj, d = 256, 4 heads, 9
     layers) on a synthetic HPatches tree at 512^2 (6 pairs), top_k 1000,
     at fixed depth and adaptive: no fallback; per pair the keypoints
     equal to the plain twin's, and LightGlue on the runner's inputs held
     against a float64 witness on the host (`lightglue_witness`): the
     randomized weights' scores of thousands carry float32 rounding from
     ~2e-5 of the largest score at depth 1 to ~0.3 at depth 9, so the card
     must be as close to float64 as its plain twin at depths 1, 2 and 9
     and at every adaptive decision, and card and plain twin may part
     (matches, or a stop or prune decision) only where float64 shows the
     decision within their measured error; the matches of the pairs that
     do not part equal the plain twin's, their MHA too; some match at
     depth 2; kernel E on each call no further from the float64 softmax
     than 4x the plain twin + 1e-5 max(1, |v|); 18 launches a pair at
     fixed depth; E's launches a pair, ms a pair, E's time at this shape
     (CUDA events) beside its bound and SDPA's time;
 64. `python -m keypoint_bench_tpu_torch.demo`'s `run` (Alike at 512^2:
     A twice, D, RANSAC-H) against its plain twin: keypoint and match
     counts equal, PNGs byte-equal, both homographies' corners within 3
     px of the ground truth's; timed.
 65. (run after phase 5) the BatchNorm epilogue (csrc/bn_epilogue.cu):
     each of its calls in ALIKE-t's `feats` on phase 5's 16 images and
     in an R2D2 forward on four of them (8 a forward; phase 5 asserts 16
     a step) against `bn_chain` on the same inputs, bit for bit; at the
     cells' shapes ([32,8,512^2], [32,16,256^2], [32,64,16^2] with the
     residual, R2D2's [4,128,512^2] with the conv bias) the kernel and
     the chain in turns (CUDA events), the kernel's own device time and
     its byte bound, in the `kernels` line (bound_ms and the top-level
     times at R2D2's shape).
Exits non-zero without CUDA, or without the port's package beside it.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import importlib.util
import io
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE, SIZE, PAIRS, K = "cuda", 512, 16, 1000
LG_PAIRS, K_LARGE = 8, 4096     # LightGlue pairs; bench.py:314's second K
LK_PAIRS = 8                    # bench.py:430's batch of the LK step
AUC_PAIRS, AUC_BLOBS, AUC_NHYP = 8, 2400, 4096  # bench.py:258-264
VO_FRAMES, VO_NHYP, VO_MAXD = 32, 4096, 5.0      # bench.py:366-392
VO_SPLAT_FRAMES = 8                              # configs/vo_synthetic.yaml
VO_LK = {"distance": 0, "win_size": 21, "levels": 3, "interation": 40}
VO_SEEDS = range(5)
# The JAX package's runner on the CPU on the same 8 splat frames
# (tools/vo_cpu_reference.py): the median over the RANSAC keys of
# VO_SEEDS of the ATE of configs/vo_synthetic.yaml and of the
# pair-by-pair optical_flow run with VO_LK. The port's runner's median
# over its generator seeds must stay below twice these.
JAX_CPU_ATE = {"pipelined_ba": 0.009197223262693427,
               "sequential_lk": 0.008769001315207312}
# The detector family (phases 24-27): bench.py:641's dense batch of 4
# pairs; the models with golden randomized weights; the classic detectors
# (model_params, no weights); test_models.py's golden tolerances
DENSE_PAIRS = 4
DESC_MODELS = ("EdgePoint", "GoodPoint", "LETNet", "r2d2", "DISK", "sfd2",
               "D2Net")
DETECTOR_MODELS = ("KeyNet", "Harris", "ORB", "SIFT")
FAMILY = DESC_MODELS + DETECTOR_MODELS
GOLDEN_MODELS = ("DISK", "sfd2", "D2Net")
CLASSIC_MODELS = ("Harris", "ORB", "SIFT")
SWEEP_EXTRA = GOLDEN_MODELS + ("ORB", "SIFT")
GOLDEN_TOL = {"LETNet": (2e-4, 0), "GoodPoint": (2e-4, 0),
              "EdgePoint": (2e-4, 0), "KeyNet": (1e-2, 1e-4),
              "r2d2": (5e-4, 0), "DISK": (5e-4, 0), "sfd2": (1e-3, 1e-3),
              "D2Net": (1e-3, 1e-3)}
# The JAX package's run_sweep on the CPU over the same sweep
# (tools/sweep_cpu_reference.py): each model's repeatability, printed
# beside the card's; sfd2's randomized weights leave it no keypoint
JAX_CPU_SWEEP = {
    "Alike": 0.8695000112056732,
    "EdgePoint": 0.885000005364418,
    "GoodPoint": 0.8362499922513962,
    "LETNet": 0.846000000834465,
    "KeyNet": 0.8754999935626984,
    "r2d2": 0.8814999908208847,
    "Harris": 0.7237499952316284,
    "DISK": 0.4012499898672104,
    "sfd2": 0.0,
    "D2Net": 0.21525000035762787,
    "ORB": 0.8264999985694885,
    "SIFT": 0.8646625578403473,
}
# H100 SXM peaks (vendor datasheet): HBM bytes/s, f32 FLOP/s (an FMA
# counts 2). Compares, max and adds issue at most one per f32 lane and
# clock, half the FMA-counted rate.
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
PEAK_F32_OPS = PEAK_F32 / 2


def log(*args):
    print(*args, flush=True)


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    log(f"== {name}")
    yield
    log(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)")


def cuda_ms(fn, iters=10, warmup=2):
    """Mean device time of fn() in ms, by CUDA events over `iters` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(fn, other, iters=10, other_iters=5):
    """(ms of fn, ms of other, the four readings): fn, other, other, fn
    timed one after the other on one card, each the mean of its two."""
    a1 = cuda_ms(fn, iters=iters)
    b1 = cuda_ms(other, iters=other_iters, warmup=1)
    b2 = cuda_ms(other, iters=other_iters, warmup=1)
    a2 = cuda_ms(fn, iters=iters)
    return (a1 + a2) / 2, (b1 + b2) / 2, [a1, b1, b2, a2]


def ptxas_info(name):
    """What `nvcc -Xptxas -v` reports for csrc/<name>.cu: the lines that
    name registers, shared memory, barriers and spills. Compiles to a
    throw-away cubin next to the built libraries."""
    from keypoint_bench_tpu_torch.ops import _build
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(_build.BUILD_DIR, f"{name}.{os.getpid()}.cubin")
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    proc = subprocess.run(
        [_build._nvcc(), *flags, "-Xptxas", "-v", "-cubin", "-o", out,
         os.path.join(_build.CSRC_DIR, f"{name}.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -Xptxas -v failed for {name}.cu:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.remove(out)
    return [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "registers" in ln or "spill" in ln]


@contextlib.contextmanager
def plain_twins():
    """Route CUDA tensors through the kernels' plain twins (the reference
    the kernels are held against); restored on exit."""
    from keypoint_bench_tpu_torch.models.common import bn_chain
    from keypoint_bench_tpu_torch.ops import (cuda_attention, cuda_bn,
                                              cuda_lk, cuda_match, cuda_nms,
                                              cuda_sample)
    from keypoint_bench_tpu_torch.ops.attention import fused_attention
    from keypoint_bench_tpu_torch.ops.detect import fast_nms, peel_topk
    from keypoint_bench_tpu_torch.ops.lk import _lk_level
    from keypoint_bench_tpu_torch.ops.matching import nn_dists
    from keypoint_bench_tpu_torch.ops.sparse_desc import sample_branches
    saved = (cuda_nms.nms_cuda, cuda_sample.sample_cuda,
             cuda_match.nn_dists_cuda, cuda_attention.attention_cuda,
             cuda_lk.lk_level_cuda, cuda_nms.peel_cuda, cuda_bn.bn_epilogue)
    cuda_nms.nms_cuda = fast_nms
    cuda_sample.sample_cuda = sample_branches
    cuda_match.nn_dists_cuda = nn_dists
    cuda_attention.attention_cuda = fused_attention
    cuda_lk.lk_level_cuda = _lk_level
    cuda_nms.peel_cuda = peel_topk
    cuda_bn.bn_epilogue = bn_chain
    try:
        yield
    finally:
        (cuda_nms.nms_cuda, cuda_sample.sample_cuda,
         cuda_match.nn_dists_cuda, cuda_attention.attention_cuda,
         cuda_lk.lk_level_cuda, cuda_nms.peel_cuda,
         cuda_bn.bn_epilogue) = saved


@contextlib.contextmanager
def recording(module, name):
    """Record the arguments of every call of module.<name>, which still
    runs as it is; restored on exit."""
    calls, real = [], getattr(module, name)

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    setattr(module, name, record)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def kernel_handles():
    """The kernels' launch counters (the seven kernels and the bf16
    instantiation of B), by the names in the JSON line."""
    from keypoint_bench_tpu_torch.ops import (cuda_attention, cuda_bn,
                                              cuda_lk, cuda_match, cuda_nms,
                                              cuda_sample)
    return {"nms": cuda_nms.KERNEL, "sample": cuda_sample.KERNEL,
            "nn_match": cuda_match.KERNEL, "attention": cuda_attention.KERNEL,
            "lk": cuda_lk.KERNEL, "peel": cuda_nms.PEEL_KERNEL,
            "sample_bf16": cuda_sample.KERNEL_BF16,
            "bn_epilogue": cuda_bn.KERNEL}


def reset_launches():
    for k in kernel_handles().values():
        k.launches = 0


def read_launches():
    return {n: k.launches for n, k in kernel_handles().items()}


def check_nn(got, want, a, b):
    """Kernel D's (nn01, d01, nn10, d10) against the plain twin's, in
    float64 from the inputs: indices equal except near ties (the two
    candidates' distances within 1e-5 of |a|^2 + |b|^2, the operands'
    scale), distances within 1e-4 of that scale. Returns ([near ties
    between penalty-free pairs, near ties where a penalty sits], max abs
    error of d over penalty-free pairs, max error relative to scale)."""
    a64, b64 = a.double(), b.double()
    near, err_free, rel = [0, 0], 0.0, 0.0
    for side, (x, y) in enumerate(((a64, b64), (b64, a64))):
        nn_g, d_g = got[2 * side].long(), got[2 * side + 1].double()
        nn_w, d_w = want[2 * side].long(), want[2 * side + 1].double()
        xn, yn = (x * x).sum(-1), (y * y).sum(-1)

        def dist(nn):
            yy = y.gather(1, nn[..., None].expand(*nn.shape, y.shape[-1]))
            return ((x - yy) ** 2).sum(-1), xn + yn.gather(-1, nn)

        dg, scale = dist(nn_g)
        dw, _ = dist(nn_w)
        differ = nn_g != nn_w
        if not bool(((dg - dw).abs() <= 1e-5 * scale)[differ].all()):
            raise AssertionError("kernel D picks a neighbour that is not a "
                                 "near tie of the plain twin's")
        e = (d_g - d_w).abs()
        if not bool((e <= 1e-4 * scale).all()):
            raise AssertionError(f"kernel D distances differ by "
                                 f"{float((e / scale).max())} of scale")
        free = scale < 1e4          # no penalty at either end
        near[0] += int((differ & free).sum())
        near[1] += int((differ & ~free).sum())
        rel = max(rel, float((e / scale).max()))
        if bool(free.any()):
            err_free = max(err_free, float(e[free].max()))
    return near, err_free, rel


def close_scores(got, want):
    """LightGlue log scores: masked entries masked on both sides, the
    difference's norm within 1e-4 of the reference's, each entry within
    1e-3 of the largest unmasked score. Returns the relative norm."""
    live = want > -1e8
    if not bool(((got > -1e8) == live).all()):
        raise AssertionError("LightGlue masks differ")
    diff = (got - want).abs()[live]
    rel = float(diff.norm() / want[live].norm())
    if not (float(diff.max()) <= 1e-3 * float(want[live].abs().max())
            and rel <= 1e-4):
        raise AssertionError(f"LightGlue scores differ: {rel}")
    return rel


def profile_step(step, top=6, count=False):
    """One step under torch.profiler: (device busy ms, host window ms,
    [(kernel, device ms)] of the `top` kernels by device time), with
    count=True also the number of device activities (kernels, copies,
    sets). Busy time is the union of the device activity intervals; the
    window spans every recorded event, host and device."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy, end, per_kernel = 0.0, float("-inf"), {}
    for e in sorted(device, key=lambda e: e.time_range.start):
        a, b = e.time_range.start, e.time_range.end
        per_kernel[e.key] = per_kernel.get(e.key, 0.0) + (b - a) / 1e3
        if b > end:
            busy += b - max(a, end)
            end = b
    window = (max(e.time_range.end for e in events)
              - min(e.time_range.start for e in events)) if events else 0.0
    kernels = sorted(per_kernel.items(), key=lambda kt: -kt[1])[:top]
    if count:
        return busy / 1e3, window / 1e3, kernels, len(device)
    return busy / 1e3, window / 1e3, kernels


def match_bound(a, b):
    """(ms, bound_by) of kernel D on a [B,M,D], b [B,N,D]: a and b read
    once, nn and d written once per row and column; 2*M*N*D FLOPs of the
    distance products at the FMA rate, plus 5 operations per (i, j) at the
    add / compare rate: the two norms added, 2ab scaled and subtracted, and
    one compare each for the row and the column minimum."""
    bsz, m, d = a.shape
    n = b.shape[1]
    t_bytes = (4 * bsz * (m + n) * d + 8 * bsz * (m + n)) / PEAK_BYTES
    t_ops = (2 * bsz * m * n * d / PEAK_F32
             + 5 * bsz * m * n / PEAK_F32_OPS)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_bound(q, m):
    """(ms, bound_by, exps) of kernel E on q [..., n, 64] against m keys:
    q, k, v and the mask read once, the output written once; 4*n*m*dh
    FLOPs per slice (QK^T and PV) at the f32 FMA rate. The n*m
    exponentials are counted apart (the peak table has no rate for them)."""
    dh, n = q.shape[-1], q.shape[-2]
    g = q.numel() // (n * dh)
    t_bytes = (4 * g * dh * (2 * n + 2 * m) + g * m) / PEAK_BYTES
    t_ops = 4 * g * n * m * dh / PEAK_F32
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", g * n * m)


def nms_bound(maps, rounds):
    """(ms, bound_by): read + write each f32 map once; the operations the
    function needs, independent of d, per pixel:
      local-max mask, 14: the row maxima of the d values left and right of
        a pixel are one width-d sliding max (van Herk / Gil-Werman, 3 max),
        the full row max 2 more, the column maxima of that over the d rows
        above and below one more sliding max (3); before/after 2,
        the strict / >= compares and their and 3, the count 1;
      suppression, 7: a box count by running sums (2 per axis), minus the
        pixel itself, a compare and a select.
    The mask runs once before the rounds, both run in every round this
    run's maps needed; all at the compare / add rate."""
    n = maps.numel()
    hw = maps.shape[-1] * maps.shape[-2]
    t_bytes = 2 * n * 4 / PEAK_BYTES
    ops = (int(rounds.sum()) * (14 + 7) + maps.shape[0] * 14) * hw
    t_ops = ops / PEAK_F32_OPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nms_tile_work(maps, d, max_iter=30, min_value=0.0, tile=32):
    """The plain fixpoint's changes round by round, for kernel A's check and
    its recounted bound: (tiles whose mask, tiles whose suppression, need
    recomputing per round, summed over the batch; pixels whose mask,
    pixels whose suppression, need recomputing, over all rounds). A pixel's
    mask depends only on p within d of it, and its suppression only on the
    mask within d: a pixel needs its mask again where bits of p changed
    within d of it in that round's suppression, and its suppression where
    the mask changed within d of it in the round before, on maps still
    running. A tile needs them where such a change lies in its 3 x 3 tile
    neighbourhood (kernel A's granularity). Round 0's mask and round 1's
    suppression take every pixel. Built from ops/detect.py's plain phases,
    not from the kernel."""
    import torch
    import torch.nn.functional as F
    from keypoint_bench_tpu_torch.ops.detect import (_local_max_mask,
                                                     _others_in_window)
    p = maps.float()
    b, h, w = p.shape
    ty, tx = -(-h // tile), -(-w // tile)

    def near_tile(changed):
        pad = F.pad(changed.float(), (0, tx * tile - w, 0, ty * tile - h))
        per_tile = F.max_pool2d(pad[:, None], tile)
        return F.max_pool2d(per_tile, 3, 1, 1)[:, 0] > 0

    def near_px(changed):
        pooled = F.max_pool2d(changed.float()[:, None], 2 * d + 1, 1, d)
        return pooled[:, 0] > 0

    mv = torch.tensor(min_value, dtype=maps.dtype).float().item()
    mask = _local_max_mask(p, d)
    count = mask.sum((1, 2))
    prev = torch.full_like(count, -1)
    mask_changed = torch.ones_like(mask)
    mask_tiles, supp_tiles = [b * ty * tx], [0]
    mask_px, supp_px = b * h * w, 0
    for _ in range(max_iter):
        active = count != prev
        if not bool(active.any()):
            break
        live = active[:, None, None]
        supp_tiles.append(int((near_tile(mask_changed) & live).sum()))
        supp_px += int((near_px(mask_changed) & live).sum())
        supp = _others_in_window(mask, d) & live
        new_p = torch.where(supp, torch.full_like(p, mv), p)
        p_changed = new_p.view(torch.int32) != p.view(torch.int32)
        mask_tiles.append(int(near_tile(p_changed).sum()))
        mask_px += int(near_px(p_changed).sum())
        p = new_p
        new_mask = _local_max_mask(p, d)
        mask_changed = (new_mask != mask) & active[:, None, None]
        mask = torch.where(active[:, None, None], new_mask, mask)
        prev = torch.where(active, count, prev)
        count = torch.where(active, new_mask.sum((1, 2)), count)
    return mask_tiles, supp_tiles, mask_px, supp_px


def nms_change_bound(maps, mask_px, supp_px):
    """(ms, bound_by) of kernel A for the work this run's maps need, on the
    pixels nms_tile_work says need it: nms_bound's 14 operations a pixel
    for the mask (compares of floats); its 7 for the suppression at the
    word rate, 32 pixels an operation (the suppression of a bit mask works
    on 32 columns at once); each f32 map read and written once."""
    t_bytes = 2 * maps.numel() * 4 / PEAK_BYTES
    t_ops = (14 * mask_px + 7 * supp_px / 32) / PEAK_F32_OPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def sample_taps_used(feats, px, py, h, w):
    """Per branch of kernel B's function: (channels, h_i, w_i, map, row,
    column of every tap with non-zero weight, taps an axis), from the plain
    taps on this run's keypoints."""
    import torch
    from keypoint_bench_tpu_torch.ops.sparse_desc import (_axis_taps_direct,
                                                          _axis_taps_up)
    b = px.shape[0]
    out = []
    for i, f in enumerate(feats):
        c, hi, wi = f.shape[1], f.shape[2], f.shape[3]
        if i == 0:
            rb, wr = _axis_taps_direct(py, hi)
            cb, wc = _axis_taps_direct(px, wi)
        else:
            rb, wr = _axis_taps_up(py, h, hi)
            cb, wc = _axis_taps_up(px, w, wi)
        t = wr.shape[-1]
        ar = torch.arange(t, device=px.device)
        used = (wr[..., :, None] != 0) & (wc[..., None, :] != 0)
        rows = (rb[..., None] + ar)[..., :, None].expand(used.shape)
        cols = (cb[..., None] + ar)[..., None, :].expand(used.shape)
        bidx = torch.arange(b, device=px.device)[:, None, None, None]
        out.append((c, hi, wi, bidx.expand(used.shape)[used], rows[used],
                    cols[used], t))
    return out


def sample_bound(feats, px, py, h, w):
    """(ms, bound_by): the feature values this run's keypoints need (taps
    with non-zero weight, distinct per map, all channels; at the maps'
    bytes a value), the coordinates read once and the samples written
    once; 2 flops per tap product."""
    import torch
    b, k = px.shape
    nbytes = 2 * px.numel() * 4
    flops = 0
    size = feats[0].element_size()
    for c, hi, wi, bi, r, q, t in sample_taps_used(feats, px, py, h, w):
        nbytes += int(torch.unique((bi * hi + r) * wi + q).numel()) * c * size
        nbytes += b * c * k * 4                          # the samples out
        flops += 2 * b * c * k * (t * t + t)
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_F32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def sample_sector_bound(feats, px, py, h, w):
    """(ms, bound_by, feature bytes) of kernel B reading the channel-major
    features as they are laid out: one 32-byte sector per distinct (map,
    channel, row, sector) that a tap with non-zero weight touches, the
    coordinates read once and the samples written once; sample_bound's
    flops."""
    import torch
    b, k = px.shape
    nbytes = 2 * px.numel() * 4
    feat_bytes, flops = 0, 0
    per_sector = 32 // feats[0].element_size()       # values a sector
    for c, hi, wi, bi, r, q, t in sample_taps_used(feats, px, py, h, w):
        ch = torch.arange(c, device=px.device)[:, None]
        addr = ((bi[None] * c + ch) * hi + r[None]) * wi + q[None]
        feat_bytes += int(torch.unique(addr // per_sector).numel()) * 32
        nbytes += b * c * k * 4                          # the samples out
        flops += 2 * b * c * k * (t * t + t)
    nbytes += feat_bytes
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_F32
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", feat_bytes)


def lk_bound(imgs, n, win, levels, iterations):
    """(ms, bound_by, point-iterations, ms with the gradients counted in
    every iteration) of kernel F over one optical_flow_batch on imgs
    [B,H,W,C] with n points per pair: both images of every pyramid level
    and the points read once, the tracked points written once; with T =
    win^2 * C taps and G = (win+1)^2 * C gradient corners:
      per point and iteration: three bilinear fields, one product and 3
        FMAs per tap and field; di and the five sums, one subtraction and
        5 FMAs per tap;
      per point and level, once: the template patch (one product, 3 FMAs
        per tap) and the gradients, separable: a 3-tap column (row) sum per
        corner, one FMA and one add, shared by its neighbours, and one
        subtraction, for each of dx and dy: 2 FMAs and 4 adds per corner.
    The gradients depend on the window's integer start alone, and the
    least an implementation needs is one window per point and level (a
    start that never moves), so the bound counts them once. The fourth
    value counts them in every iteration, as this bound did before the
    kernel cached its windows, so that earlier readings stay comparable.
    FMAs at the f32 FMA rate (2 FLOPs each), the rest at the add rate.
    The iteration count is fixed: no point stops early."""
    b, h, w, c = imgs.shape
    t, g = win * win * c, (win + 1) * (win + 1) * c
    pt_levels = b * n * levels
    pt_iters = pt_levels * iterations
    px = sum((h // 2 ** lv) * (w // 2 ** lv) for lv in range(levels))
    t_bytes = (2 * b * px * c * 4 + levels * 3 * b * n * 2 * 4) / PEAK_BYTES

    def t_ops(grad_times):
        fma = pt_iters * 14 * t + pt_levels * 3 * t + grad_times * 2 * g
        single = pt_iters * 4 * t + pt_levels * t + grad_times * 4 * g
        return 2 * fma / PEAK_F32 + single / PEAK_F32_OPS

    once, every = t_ops(pt_levels), t_ops(pt_iters)
    return (max(t_bytes, once) * 1e3,
            "bytes" if t_bytes >= once else "operations", pt_iters,
            max(t_bytes, every) * 1e3)


def peel_bound(maps, per_chunk, border):
    """(ms, bound_by) of kernel C on maps [B,H,W]: every value outside the
    border band read once (the band reads 0, so the function needs none of
    it), per_chunk values and indices written per 128-column chunk; one
    compare per value read and round at the compare rate."""
    b, h, w = maps.shape
    nc = (w // 128) * per_chunk
    inner = b * max(h - 2 * border, 0) * max(w - 2 * border, 0)
    t_bytes = (4 * inner + 8 * b * h * nc) / PEAK_BYTES
    t_ops = per_chunk * inner / PEAK_F32_OPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def peel_equal(v, i, pv, pi):
    """Kernel C's (values, indices) against the plain peel's: values equal
    under == (so -0.0 == +0.0), NaN matching NaN; indices equal."""
    import torch
    nan = torch.isnan(pv)
    return (torch.equal(nan, torch.isnan(v))
            and torch.equal(torch.where(nan, 0.0, v), torch.where(nan, 0.0, pv))
            and torch.equal(i, pi))


def gauge_gap(got, ref):
    """Two BA solutions of one monocular window, each (R [C,3,3], t [C,3],
    points [P,3]). With camera 0 fixed, BA still leaves the scale about
    camera 0's centre free (the damping alone holds it), so two runs that
    sum in another order drift apart along it. Returns (the scale s that
    best maps got's camera centres onto ref's about camera 0, the largest
    rotation gap, the largest centre gap after the scale, the largest
    point gap after it over max(1, |X_ref|)); numpy float64."""
    import numpy as np
    (R, t, p), (Rr, tr, pr) = ((np.asarray(a, np.float64) for a in x)
                               for x in (got, ref))
    c = -np.einsum("cji,cj->ci", R, t)
    cr = -np.einsum("cji,cj->ci", Rr, tr)
    o = cr[0]
    den = ((c - o) ** 2).sum()
    s = float(((c - o) * (cr - o)).sum() / den) if den > 0 else 1.0
    gap_c = float(np.abs(o + s * (c - o) - cr).max())
    gap_p = float((np.abs(o + s * (p - o) - pr)
                   / np.maximum(1.0, np.abs(pr))).max())
    return s, float(np.abs(R - Rr).max()), gap_c, gap_p


def peel_rounds(vals, per_chunk):
    """Kernel C's rounds per chunk, [B,H,n_blk] int64, reckoned from the
    plain peel's candidates vals [B,H,n_blk*per_chunk]: one round per run
    of equal values (a batch of ties, or the -inf fill); a NaN chunk,
    settled by one ballot, counts one."""
    import torch
    b, h, nc = vals.shape
    v = vals.reshape(b, h, nc // per_chunk, per_chunk)
    new = (v[..., 1:] != v[..., :-1]) & ~torch.isnan(v[..., 1:])
    return 1 + new.sum(-1)


def border_points(b, n, h, w, gen, dev):
    """[b,n,2] points within 3 px of a border of an h x w image, inside or
    outside it; the first eight of every batch sit at the four corners."""
    import torch
    u = torch.rand((4, b, n), generator=gen, device=dev)
    x = u[0] * (w + 5) - 3
    y = u[1] * (h + 5) - 3
    near = u[2] * 6 - 3
    side = (u[3] * 4).long()
    x = torch.where(side == 0, near, torch.where(side == 1, w - 1 + near, x))
    y = torch.where(side == 2, near, torch.where(side == 3, h - 1 + near, y))
    corners = torch.tensor([[0.5, 0.5], [w - 1.5, 0.5], [0.5, h - 1.5],
                            [w - 1.5, h - 1.5], [-2.0, -2.0], [w + 1.0, -2.0],
                            [-2.0, h + 1.0], [w + 1.0, h + 1.0]], device=dev)
    pts = torch.stack([x, y], -1)
    pts[:, :8] = corners
    return pts


def lk_det(img2, pts, win):
    """det of the 2x2 Gauss-Newton system of `_lk_level` at pts [B,N,2] of
    img2 [B,H,W,C] (the quantity its 1e-6 guard tests)."""
    from keypoint_bench_tpu_torch.ops.lk import (_gradients, _pad_field,
                                                 _window_bilinear)
    import torch
    pad = win + 1
    dx, dy = _gradients(img2)
    f = _window_bilinear(_pad_field(torch.cat([dx, dy], -1), pad), pts, win,
                         pad)
    c = img2.shape[-1]
    jx, jy = f[..., :c].flatten(-3), f[..., c:].flatten(-3)
    return ((jx * jx).sum(-1) * (jy * jy).sum(-1)
            - (jx * jy).sum(-1) ** 2)


def timed_windows(step, windows=7, per_window=3, warmup=2):
    """Host seconds per step: `windows` windows of `per_window` steps, each
    ending in a device synchronize, after `warmup` steps."""
    import torch
    for _ in range(warmup):
        step()
    out = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(per_window):
            step()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / per_window)
    return out


def timed_in_turns(step, other, rounds=4, per_window=3):
    """Host seconds per step of `step` and of `other`: `rounds` windows of
    `per_window` steps each, taken in turns (step, other, other, step,
    ...), each ending in a device synchronize, after two warm-up steps of
    each."""
    import torch
    for f in (step, other, step, other):
        f()
    out = ([], [])
    for r in range(rounds):
        for i in ((0, 1) if r % 2 == 0 else (1, 0)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(per_window):
                (step, other)[i]()
            torch.cuda.synchronize()
            out[i].append((time.perf_counter() - t0) / per_window)
    return out


def auc_phases(dev, dp, card, errs):
    """The AUC path at bench.py's shapes (phases 16-18): the step with
    kernels A and E held on its own calls and against its plain-twin run,
    timed; RANSAC-E + recoverPose on the card against the CPU on
    ground-truth correspondences; the runner's AUC task and SE3
    repeatability. Returns the numbers for the kernels JSON line."""
    from dataclasses import replace

    import numpy as np
    import torch

    from keypoint_bench_tpu_torch.datasets.synthetic import \
        SyntheticSE3Dataset
    from keypoint_bench_tpu_torch.geometry import ransac
    from keypoint_bench_tpu_torch.geometry.warp import warp_se3
    from keypoint_bench_tpu_torch.models import get_model
    from keypoint_bench_tpu_torch.models.lightglue import (
        lightglue_forward, sample_descriptors_lg)
    from keypoint_bench_tpu_torch.ops import cuda_attention, cuda_nms
    from keypoint_bench_tpu_torch.ops.attention import fused_attention
    from keypoint_bench_tpu_torch.ops.detect import (detection_batch,
                                                     fast_nms)
    from keypoint_bench_tpu_torch.ops.matching import take_rows
    from keypoint_bench_tpu_torch.pipeline import xfeat_auc_step
    from keypoint_bench_tpu_torch.runner import EvalConfig, Evaluator
    from keypoint_bench_tpu_torch.tasks.auc import (estimate_pose_pair,
                                                    pose_error)
    from keypoint_bench_tpu_torch.weights import (
        lightglue_input_proj_params, load_golden_params)

    out = {}
    with phase(f"data: {AUC_PAIRS} SE3 pairs at {SIZE}^2, {AUC_BLOBS} "
               f"blobs"):
        ds = SyntheticSE3Dataset(AUC_PAIRS, SIZE, 0, AUC_BLOBS)
        items = [ds[i] for i in range(AUC_PAIRS)]

        def stacked(key, group=None):
            return torch.from_numpy(np.stack([
                (it[group] if group else it)[key] for it in items])).to(dev)

        imgs0, imgs1 = stacked("image0"), stacked("image1")
        wp = {k: stacked(k, "warp01_params") for k in (
            "pose01", "bbox0", "bbox1", "depth0", "depth1", "intrinsics0",
            "intrinsics1")}
        Ks, poses = wp["intrinsics0"], wp["pose01"]
    xf = get_model("XFeat")(load_golden_params("XFeat", dev)).eval()
    lg = lightglue_input_proj_params(device=dev)
    out["data"] = (imgs0, imgs1, Ks, poses, lg)     # for the bf16 phases
    out["items"] = items                            # for phase 53

    with phase(f"xfeat_auc_step: {AUC_PAIRS} pairs at {SIZE}^2, n_hyp "
               f"{AUC_NHYP}"):
        def step(seed=0):
            return xfeat_auc_step(
                xf, lg, imgs0, imgs1, Ks, poses, dp,
                torch.Generator(device=dev).manual_seed(seed), AUC_NHYP,
                device=DEVICE)

        reset_launches()
        with recording(cuda_nms, "nms_cuda") as nms_calls, \
                recording(cuda_attention, "attention_cuda") as att_calls:
            err, n_in, k0, k1, m0, mask = step()
            torch.cuda.synchronize()
        got = read_launches()
        log(f"  launches in one run: {got}")
        if got["nms"] != 2 or got["attention"] != 18:
            raise AssertionError(f"the AUC step launches kernel A twice and "
                                 f"kernel E 18 times; got {got}")
        out["launches"] = {k: got[k] for k in ("nms", "attention")}
        for args, kw in nms_calls:
            g, w = cuda_nms.nms_cuda(*args, **kw), fast_nms(*args, **kw)
            errs["nms"] = max(errs["nms"],
                              float((g.float() - w.float()).abs().max()))
            if not torch.equal(g, w):
                raise AssertionError("kernel A differs from fast_nms on the "
                                     "step's XFeat heatmaps")
        # an output row is a convex combination of v's rows, so its
        # rounding scales with |v|, which reaches ~120 in the deep layers
        # of the randomized weights: 1e-5 of max(1, max |v|) of the call
        att_err, att_rel = 0.0, 0.0
        for i, (args, kw) in enumerate(att_calls):
            g = cuda_attention.attention_cuda(*args, **kw)
            w = fused_attention(*args, **kw)
            e = float((g - w).abs().max())
            scale = max(1.0, float(args[2].abs().max()))
            att_err, att_rel = max(att_err, e), max(att_rel, e / scale)
            log(f"  kernel E call {i}: max abs err {e:.3g}, max |v| "
                f"{scale:.3g}, err / max(1, |v|) {e / scale:.3g}")
            if not (e <= 1e-5 * scale and bool(torch.isfinite(g).all())):
                raise AssertionError("kernel E differs from fused_attention "
                                     "on the step's LightGlue calls")
        errs["attention"] = max(errs["attention"], att_err)
        out["attention_err_over_v_scale"] = att_rel
        log(f"  kernel A on the step's {len(nms_calls)} heatmap batches "
            f"{tuple(nms_calls[0][0][0].shape)}: equal to fast_nms; kernel E "
            f"on its {len(att_calls)} calls {tuple(att_calls[0][0][0].shape)}"
            f": max abs err {att_err:.3g}, {att_rel:.3g} of max(1, |v|)")
        del nms_calls[:], att_calls[:]
        with plain_twins():
            err_p, n_in_p, k0_p, k1_p, m0_p, mask_p = step()
        n_valid = int((k0[..., 2] > 0).sum() + (k1[..., 2] > 0).sum())
        log(f"  errors {err.tolist()} (plain {err_p.tolist()}); inliers "
            f"{n_in.tolist()}; matches {int(mask.sum())} (plain "
            f"{int(mask_p.sum())}); m0 rows that differ "
            f"{int((m0 != m0_p).sum())}; keypoints with a score "
            f"{n_valid}")
        if not (torch.equal(k0, k0_p) and torch.equal(k1, k1_p)):
            raise AssertionError("AUC step keypoints differ from plain")
        if not (err.shape == (AUC_PAIRS,) and bool(torch.isfinite(err).all())
                and bool(((err >= 0) & (err <= 180)).all())
                and bool(((err - err_p).abs() <= 1e-3).all())):
            raise AssertionError("AUC step errors malformed or differ from "
                                 "the plain-twin step")
        windows = timed_windows(step)
        dt = statistics.median(windows)
        pps = [AUC_PAIRS / w for w in windows]
        out["pairs_per_s"] = AUC_PAIRS / dt
        log(f"  step: median {dt * 1e3:.3f} ms per {AUC_PAIRS}-pair batch, "
            f"{AUC_PAIRS / dt:.2f} pairs/s (min {min(pps):.2f}, max "
            f"{max(pps):.2f}) on {card}")
        gen_t = torch.Generator(device=dev).manual_seed(0)
        scale = torch.tensor([SIZE - 1.0, SIZE - 1.0], device=dev)
        with torch.inference_mode():
            heat0, dm0 = xf(imgs0)
            heat1, dm1 = xf(imgs1)
            d0, v0 = detection_batch(heat0, dp)
            d1, v1 = detection_batch(heat1, dp)
            p0, p1 = d0[..., :2] * scale, d1[..., :2] * scale
            f0 = sample_descriptors_lg(p0, dm0, 8)
            f1 = sample_descriptors_lg(p1, dm1, 8)
            lm0, _, lok = lightglue_forward(lg, p0, v0, f0, p1, v1, f1)
            mp1, lmask = take_rows(p1, lm0.clamp_min(0)), lok & v0
            st = {f"forward, XFeat on 2 x {AUC_PAIRS} images":
                  cuda_ms(lambda: (xf(imgs0), xf(imgs1)), iters=5),
                  f"detection_batch, 2 x {AUC_PAIRS} maps":
                  cuda_ms(lambda: (detection_batch(heat0, dp),
                                   detection_batch(heat1, dp)), iters=5),
                  "descriptors + LightGlue (kernel E)":
                  cuda_ms(lambda: lightglue_forward(
                      lg, p0, v0, sample_descriptors_lg(p0, dm0, 8), p1, v1,
                      sample_descriptors_lg(p1, dm1, 8)), iters=5),
                  "RANSAC-E + recoverPose on the step's matches":
                  cuda_ms(lambda: estimate_pose_pair(
                      p0, mp1, lmask, Ks, Ks, gen_t, n_hyp=AUC_NHYP),
                      iters=3)}
        out["stages_ms"] = st
        for name, ms in st.items():
            log(f"  stage {name}: {ms:.4f} ms")
        busy, window, top = profile_step(step)
        out["idle_share"] = 1.0 - busy / window if window > 0 else None
        log(f"  profiled step: device busy {busy:.3f} ms of a {window:.3f} "
            f"ms window, idle share {out['idle_share']:.4f}"
            if window > 0 else "  profiled step: no events recorded")
        for name, ms in top:
            log(f"    device time {ms:.4f} ms: {name[:90]}")

    with phase("RANSAC-E + recoverPose: card vs CPU on ground truth"):
        # the step's keypoints and their warp_se3 correspondences, in the
        # warp's pixels plus 0.5 (the COLMAP centre the intrinsics expect)
        _, kw, vw = warp_se3(d0, v0, wp["pose01"], wp["bbox0"], wp["bbox1"],
                             wp["depth0"], wp["depth1"], Ks, Ks)
        g0, g1 = d0[..., :2] * SIZE + 0.5, kw * SIZE + 0.5
        samples = ransac._sample_minimal(
            vw, AUC_NHYP, 8, torch.Generator(device=dev).manual_seed(1))
        args = (g0, g1, vw, Ks, Ks)
        R, t, _, n_c, ok_c = estimate_pose_pair(*args, None, n_hyp=AUC_NHYP,
                                                samples=samples)
        Rc, tc, _, n_h, ok_h = estimate_pose_pair(
            *(a.cpu() for a in args), None, n_hyp=AUC_NHYP,
            samples=samples.cpu())
        # in float64: float32's arccos near 0 resolves only ~0.02 degrees
        e_c = pose_error(R.double(), t.double(), poses.double()).cpu()
        e_h = pose_error(Rc.double(), tc.double(), poses.double().cpu())
        n_gt = vw.sum(-1).cpu()
        log(f"  ground-truth correspondences per pair {n_gt.tolist()}; pose "
            f"error card {e_c.tolist()}, CPU {e_h.tolist()}; inliers card "
            f"{n_c.tolist()}, CPU {n_h.tolist()}")
        # float32: the card's and the CPU's SVDs of the raw-coordinate
        # normal equations differ at the conditioning's level, up to
        # 0.06 degrees of pose here; in float64 the two agree closely
        args64 = tuple(a.double() if a.is_floating_point() else a
                       for a in args)
        R, t, _, n_c64, _ = estimate_pose_pair(*args64, None, n_hyp=AUC_NHYP,
                                               samples=samples)
        Rc, tc, _, n_h64, _ = estimate_pose_pair(
            *(a.cpu() for a in args64), None, n_hyp=AUC_NHYP,
            samples=samples.cpu())
        e_c64 = pose_error(R, t, poses.double()).cpu()
        e_h64 = pose_error(Rc, tc, poses.double().cpu())
        out["ground_truth"] = (g0, g1, vw, Ks, poses)   # for phase 43
        out["ransac_card_vs_cpu_deg"] = {
            "float32": float((e_c - e_h).abs().max()),
            "float64": float((e_c64 - e_h64).abs().max())}
        log(f"  float64: pose error card {e_c64.tolist()}, CPU "
            f"{e_h64.tolist()}; largest card-CPU gap "
            f"{out['ransac_card_vs_cpu_deg']}")
        if not (bool(ok_c.all()) and torch.equal(ok_c.cpu(), ok_h)
                and bool(((e_c - e_h).abs() <= 1e-1).all())
                and bool(((n_c.cpu() - n_h).abs() <= 0.005 * n_gt).all())
                and bool(((e_c64 - e_h64).abs() <= 1e-3).all())
                and torch.equal(n_c64.cpu(), n_h64)):
            raise AssertionError("RANSAC-E + recoverPose differ between the "
                                 "card and the CPU")
        p0n = (g0 - Ks[:, None, :2, 2]) / Ks[:, None, [0, 1], [0, 1]]
        p1n = (g1 - Ks[:, None, :2, 2]) / Ks[:, None, [0, 1], [0, 1]]
        q0, q1 = ransac._take(p0n, samples), ransac._take(p1n, samples)
        ones = torch.ones_like(q0[..., 0])
        e9, _ = ransac._solve_minimal_e(q0, q1)
        es = ransac._essential_project(e9)
        gen_g = torch.Generator(device=dev).manual_seed(1)
        sub = {"RANSAC-E + recoverPose on ground truth":
               cuda_ms(lambda: estimate_pose_pair(*args, gen_g,
                                                  n_hyp=AUC_NHYP), iters=3),
               "minimal samples (Gumbel top-8 of [8,4096,1000])":
               cuda_ms(lambda: ransac._sample_minimal(vw, AUC_NHYP, 8,
                                                      gen_g), iters=3),
               "8-point solves (float64 minors of [8,4096] 8 x 9 designs)":
               cuda_ms(lambda: ransac._solve_minimal_e(q0, q1), iters=3),
               "the float32 route they replace (A^T A + SVD of "
               "[8,4096,9,9])":
               cuda_ms(lambda: ransac._solve_eightpoint(q0, q1, ones),
                       iters=3),
               "essential projections (SVD of [8,4096,3,3])":
               cuda_ms(lambda: ransac._essential_project(e9), iters=3),
               "Sampson matrix [8,4096,1000]":
               cuda_ms(lambda: ransac._sampson(es, p0n[:, None], p1n[:, None]),
                       iters=3)}
        out["ransac_ms"] = sub
        for name, ms in sub.items():
            log(f"  stage {name}: {ms:.4f} ms")
        syncs = host_syncs(lambda: estimate_pose_pair(*args, gen_g,
                                                      n_hyp=AUC_NHYP))
        out["ransac_host_syncs"] = len(syncs)
        log(f"  synchronizing operations in one RANSAC-E + recoverPose: "
            f"{len(syncs)} {sorted(set(syncs))[:3]}")

    with phase(f"AUC runner: ALIKE-t + brute force, 4 SE3 pairs at "
               f"{SIZE}^2"):
        cfg = EvalConfig(
            model_type="Alike", task_type="AUC",
            data_params={"type": "synthetic_se3", "num_pairs": 4,
                         "image_size": SIZE},
            extractor_params={"nms_dist": 6, "border_dist": 8, "top_k": K,
                              "threshold": 0, "min_score": 0.0},
            matcher_params={"type": "brute_force",
                            "brute_force_params": {"max_distance": 5.0}},
            task_params={"th": [5, 10, 20]},
            output_dir=os.path.join(ROOT, "output", "chip_smoke_auc"))
        reset_launches()
        res = Evaluator(cfg, DEVICE).run()
        got = read_launches()
        with plain_twins():
            res_p = Evaluator(cfg, DEVICE).run()
        e, e_p = (np.asarray(r["per_pair_error"]) for r in (res, res_p))
        out["runner_cfg"] = replace(cfg)          # for the bf16 phases
        cfg.task_type, cfg.task_params = "repeatability", {"th": 3}
        rep = Evaluator(cfg, DEVICE).run()["repeatability"]
        out["runner"] = {"per_pair_error": e.tolist(),
                         "AUC@20": res["AUC@20"],
                         "AUC_inliers": res["AUC_inliers"],
                         "repeatability": rep}
        log(f"  per-pair error {e.tolist()} (plain {e_p.tolist()}); AUC@5/"
            f"10/20 {[res[f'AUC@{t}'] for t in (5, 10, 20)]}; inliers "
            f"{res['AUC_inliers']}; launches {got}; SE3 repeatability {rep}")
        if got["nms"] <= 0 or got["nn_match"] <= 0:
            raise AssertionError(f"the AUC runner missed kernel A or D: {got}")
        if not (np.median(e) < 10.0 and res["AUC@20"] > 0.3 and rep > 0.1
                and np.abs(e - e_p).max() <= 1e-3):
            raise AssertionError("the AUC runner missed its gates or differs "
                                 "from the plain twins")
    return out



def host_ms(fn, iters=5):
    """Median host milliseconds of fn() (host work that the device waits
    for, or that ends in a synchronize)."""
    import torch
    out = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def host_syncs(fn):
    """The synchronizing operations one fn() makes, as
    torch.cuda.set_sync_debug_mode reports them (first lines)."""
    import warnings

    import torch
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return [str(w.message).splitlines()[0] for w in caught
            if "synchroniz" in str(w.message)]


def vo_phases(dev, dp, card, errs):
    """The VO path at bench_vo's shapes (phases 20-23): `vo_step` on 32
    frames with and without BA, kernels A, B and D held on its own calls
    and against its plain-twin run, timed; `ba_solve` on the card against
    the CPU on the step's window; the runner's `visual_odometer`
    pipelined with BA and pair by pair with optical_flow on 8 splat
    frames. Returns the numbers for the vo_step and kernels JSON lines."""
    from dataclasses import replace

    import numpy as np
    import torch

    from keypoint_bench_tpu_torch.ba import ba_solve, lm_iterations
    from keypoint_bench_tpu_torch.datasets.synthetic import (
        SyntheticSequenceDataset, SyntheticSplatSequenceDataset)
    from keypoint_bench_tpu_torch.models import get_model
    from keypoint_bench_tpu_torch.ops import cuda_match, cuda_nms, cuda_sample
    from keypoint_bench_tpu_torch.ops.detect import fast_nms
    from keypoint_bench_tpu_torch.ops.matching import (mutual_nn_match,
                                                       nn_dists)
    from keypoint_bench_tpu_torch.ops.sparse_desc import sample_branches
    from keypoint_bench_tpu_torch.pipeline import detect_frames, vo_step
    from keypoint_bench_tpu_torch.runner import EvalConfig, Evaluator
    from keypoint_bench_tpu_torch.tasks.trajectory import ate_rmse
    from keypoint_bench_tpu_torch.tasks.vo import chain_poses, vo_pair_pose
    from keypoint_bench_tpu_torch.tasks.vo_ba import (build_ba_problem,
                                                      chain_tracks, chain_w2c,
                                                      gate_window)
    from keypoint_bench_tpu_torch.weights import load_params

    out = {}
    with phase(f"data: {VO_FRAMES} synthetic-sequence frames at {SIZE}^2 "
               f"(uint8), {VO_SPLAT_FRAMES} splat frames"):
        seq = SyntheticSequenceDataset(VO_FRAMES, SIZE, 0)
        items = [seq[i] for i in range(VO_FRAMES)]
        # bench.py:377-384: decoded video frames are uint8
        frames = torch.from_numpy(np.stack([
            (np.clip(it["image0"], 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
            for it in items])).to(dev)
        scales = [float(np.linalg.norm(it["ground_truth"][:3, 3]
                                       - it["last_ground_truth"][:3, 3]))
                  for it in items]
        K_cam = np.array([[seq.fx, 0, seq.cx], [0, seq.fy, seq.cy],
                          [0, 0, 1]], np.float32)
        gt = np.stack([p[:3, 3] for p in seq.poses])
        out["data"] = (frames, K_cam, scales, gt)   # for the bf16 phases
        splat = SyntheticSplatSequenceDataset(VO_SPLAT_FRAMES, SIZE, 0)
        splat_items = [splat[i] for i in range(VO_SPLAT_FRAMES)]
    model = get_model("Alike_s2d")(load_params("Alike_s2d", device=dev))
    scale_px = torch.tensor([SIZE - 1.0, SIZE - 1.0], device=dev)

    def step(ba, seed=0):
        return vo_step(model, frames, K_cam, scales, dp,
                       torch.Generator(device=dev).manual_seed(seed),
                       VO_MAXD, VO_NHYP, ba_refine=ba, device=DEVICE)

    with phase(f"vo_step: {VO_FRAMES} frames at {SIZE}^2, n_hyp {VO_NHYP}, "
               f"without and with BA"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with recording(cuda_nms, "nms_cuda") as nms_calls, \
                recording(cuda_sample, "sample_cuda") as samp_calls, \
                recording(cuda_match, "nn_dists_cuda") as nn_calls:
            res = step(False)
            torch.cuda.synchronize()
        got = read_launches()
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        n_chunks = -(-VO_FRAMES // 8)
        log(f"  launches in one run: {got}; peak memory "
            f"{out['peak_memory_gb']:.3f} GiB")
        if not (got["nms"] == n_chunks and got["sample"] == n_chunks
                and got["nn_match"] == 2):
            raise AssertionError(f"vo_step launches A and B once a chunk "
                                 f"of 8 frames and D in one call (its 2 "
                                 f"kernels); got {got}")
        out["launches"] = {k: got[k] for k in ("nms", "sample", "nn_match")}
        for args, kw in nms_calls:
            if not torch.equal(cuda_nms.nms_cuda(*args, **kw),
                               fast_nms(*args, **kw)):
                raise AssertionError("kernel A differs from fast_nms on the "
                                     "VO step's score maps")
        samp_err = 0.0
        for args, kw in samp_calls:
            g = cuda_sample.sample_cuda(*args, **kw)
            samp_err = max(samp_err, float((g - sample_branches(
                *args, **kw)).abs().max()))
        errs["sample"] = max(errs["sample"], samp_err)
        if not samp_err <= 1e-5:
            raise AssertionError(f"kernel B on the VO step's chunks: "
                                 f"{samp_err}")
        (a, b), _ = nn_calls[0]
        near, nn_err, _ = check_nn(cuda_match.nn_dists_cuda(a, b),
                                   nn_dists(a, b), a, b)
        errs["nn_match"] = max(errs["nn_match"], nn_err)
        log(f"  kernel A on the step's {len(nms_calls)} score batches: "
            f"equal to fast_nms; kernel B on its {len(samp_calls)} chunks: "
            f"max abs err {samp_err:.3g}; kernel D on its {tuple(a.shape)} "
            f"call: near ties {near}, max abs err {nn_err:.3g}")
        del nms_calls[:], samp_calls[:], nn_calls[:]
        with plain_twins():
            res_p = step(False)
        n_valid = int(res["valid"].sum())
        differ = int((res["match_mask"] != res_p["match_mask"]).sum()
                     + ((res["nn01"] != res_p["nn01"])
                        & res["match_mask"]).sum())
        length = float(np.linalg.norm(np.diff(res_p["t_est"][:, :, 0],
                                              axis=0), axis=1).sum())
        t_gap = float(np.abs(res["t_est"] - res_p["t_est"]).max())
        log(f"  keypoints {n_valid} valid; matches {int(res['match_mask'].sum())}"
            f" (plain {int(res_p['match_mask'].sum())}), rows that differ "
            f"{differ}; inliers {res['n_inliers'].tolist()}; ok "
            f"{int(res['ok'].sum())} of {VO_FRAMES}; positions' largest gap "
            f"to the plain twin {t_gap:.3g} over a {length:.3f} trajectory")
        if not (torch.equal(res["kpts"], res_p["kpts"])
                and torch.equal(res["valid"], res_p["valid"])):
            raise AssertionError("vo_step keypoints differ from plain")
        if differ > 0.005 * n_valid:
            raise AssertionError(f"vo_step matches differ from plain: "
                                 f"{differ} rows")
        if not (np.isfinite(res["t_est"]).all()
                and res["t_est"].shape == (VO_FRAMES + 1, 3, 1)):
            raise AssertionError("vo_step trajectory malformed")
        if differ == 0 and t_gap > 1e-3 * max(length, 1e-9):
            raise AssertionError("vo_step trajectory differs from the "
                                 "plain-twin step on equal matches")
        out["ate_planar"] = ate_rmse(res["t_est"][1:, :, 0], gt)

        res_ba = step(True)
        with plain_twins():
            res_ba_p = step(True)
        log(f"  with BA: {res_ba.get('ba_tracks')} tracks, reproj "
            f"{res_ba.get('ba_reproj_before')} -> "
            f"{res_ba.get('ba_reproj_after')} px (plain "
            f"{res_ba_p.get('ba_tracks')}, {res_ba_p.get('ba_reproj_after')})")
        if "ba_tracks" not in res_ba:
            raise AssertionError("the VO step's window has too few tracks")
        if differ == 0 and not (
                res_ba["ba_tracks"] == res_ba_p["ba_tracks"]
                and abs(res_ba["ba_reproj_after"]
                        - res_ba_p["ba_reproj_after"]) <= 1e-3):
            raise AssertionError("vo_step BA differs from the plain twin")

        fps = {}
        for ba in (False, True):
            windows = timed_windows(lambda: step(ba), windows=7,
                                    per_window=1, warmup=1)
            key = "with_ba" if ba else "without_ba"
            fps[key] = VO_FRAMES / statistics.median(windows)
            all_fps = [VO_FRAMES / w for w in windows]
            log(f"  vo_step {key}: median "
                f"{statistics.median(windows) * 1e3:.3f} ms per "
                f"{VO_FRAMES}-frame window, {fps[key]:.2f} frames/s (min "
                f"{min(all_fps):.2f}, max {max(all_fps):.2f}) on {card}")
        out["frames_per_s"] = fps

        # the stages, each alone on the step's own tensors
        with torch.inference_mode():
            _, descs, kpts, valid = detect_frames(model, frames, dp, dev, True)
            d0 = torch.cat([descs[:1], descs[:-1]])
            v0 = torch.cat([valid[:1], valid[:-1]])
            k0 = torch.cat([kpts[:1], kpts[:-1]])
            nn01, mok = res["nn01"], res["match_mask"]
            p0 = k0[..., :2] * scale_px
            p1 = kpts.gather(1, nn01[..., None].expand(-1, -1, 3))[
                ..., :2] * scale_px
            gen = torch.Generator(device=dev).manual_seed(0)
            rel = [x.cpu().numpy() for x in (res["R_rel"], res["t_rel"],
                                             res["ok"])]
            st = {f"detection (Alike_s2d feats + A + B, {VO_FRAMES} frames "
                  f"in chunks of 8)":
                  cuda_ms(lambda: detect_frames(model, frames, dp, dev, True),
                          iters=3),
                  f"mutual_nn_match ({VO_FRAMES} pairs, kernel D)":
                  cuda_ms(lambda: mutual_nn_match(d0, descs, v0, valid,
                                                  VO_MAXD), iters=5),
                  f"RANSAC-E + recoverPose ([{VO_FRAMES},{VO_NHYP},{K}])":
                  cuda_ms(lambda: vo_pair_pose(
                      p0, p1, mok, K_cam[0, 0], K_cam[0, 2], K_cam[1, 2], gen,
                      VO_NHYP), iters=3),
                  "chain_poses (host)":
                  host_ms(lambda: chain_poses(*rel, np.asarray(scales)))}
            R_w2c, t_w2c = chain_w2c(*rel, scales)
            nn_np, ok_np = nn01.cpu().numpy(), mok.cpu().numpy()
            tracks = chain_tracks(nn_np, ok_np)
            kpts_px = (kpts[..., :2] * scale_px).cpu().numpy()
            prob = build_ba_problem(kpts_px, tracks, R_w2c, t_w2c, K_cam,
                                    device=dev)
            gated, _ = gate_window(prob)
            st.update({
                "BA: chain_tracks (host)":
                host_ms(lambda: chain_tracks(nn_np, ok_np)),
                "BA: build_ba_problem (host triangulation + copy)":
                host_ms(lambda: build_ba_problem(kpts_px, tracks, R_w2c,
                                                 t_w2c, K_cam, device=dev)),
                "BA: gate (initial reprojection errors)":
                cuda_ms(lambda: gate_window(prob), iters=5),
                "BA: ba_solve (8 LM iterations, Huber 2)":
                cuda_ms(lambda: ba_solve(gated, 8, 1e-2, huber_delta=2.0),
                        iters=3)})
        out["window"] = (kpts_px, tracks, R_w2c, t_w2c)   # for phase 54
        out["ba_window"] = {"C": int(prob.R.shape[0]),
                            "P": int(prob.points.shape[0]),
                            "N": int(prob.uv.shape[0]),
                            "N_gated": int(gated.mask.sum())}
        out["stages_ms"] = st
        for name, ms in st.items():
            log(f"  stage {name}: {ms:.4f} ms")
        log(f"  BA window: C {out['ba_window']['C']} cameras, P "
            f"{out['ba_window']['P']} points, N {out['ba_window']['N']} "
            f"observations ({out['ba_window']['N_gated']} past the gate); "
            f"W [{out['ba_window']['P']},{out['ba_window']['C']},6,3] f32 "
            f"{out['ba_window']['P'] * out['ba_window']['C'] * 72 / 1e6:.1f}"
            f" MB")
        out["idle_share"] = {}
        for ba in (False, True):
            busy, window, top = profile_step(lambda: step(ba))
            key = "with_ba" if ba else "without_ba"
            out["idle_share"][key] = (1.0 - busy / window if window > 0
                                      else None)
            log(f"  profiled step {key}: device busy {busy:.3f} ms of a "
                f"{window:.3f} ms window, idle share "
                f"{out['idle_share'][key]}")
            for name, ms in top:
                log(f"    device time {ms:.4f} ms: {name[:90]}")
        syncs = {"ba_solve": host_syncs(lambda: ba_solve(
                     gated, 8, 1e-2, huber_delta=2.0)),
                 "vo_step": host_syncs(lambda: step(False)),
                 "vo_step_with_ba": host_syncs(lambda: step(True))}
        out["host_syncs"] = {k: len(v) for k, v in syncs.items()}
        for k, v in syncs.items():
            log(f"  synchronizing operations in one {k}: {len(v)} "
                f"{sorted(set(v))[:3]}")
        if syncs["ba_solve"]:
            raise AssertionError("ba_solve synchronizes with the host")

    with phase("ba_solve: card vs CPU on the VO step's window"):
        prob_h = build_ba_problem(kpts_px, tracks, R_w2c, t_w2c, K_cam,
                                  device="cpu")
        out["ba_card_vs_cpu"] = {}
        for dt, err_tol, pose_tol in ((torch.float32, 1e-3, 1e-3),
                                      (torch.float64, 1e-6, 1e-6)):
            sols = []
            for pr in (prob, prob_h):
                pr = replace(pr, R=pr.R.to(dt), t=pr.t.to(dt),
                             points=pr.points.to(dt), uv=pr.uv.to(dt),
                             K=pr.K.to(dt))
                g, e0 = gate_window(pr)
                R, t, p, e = ba_solve(g, 8, 1e-2, huber_delta=2.0)
                acc = lm_iterations(g, 8, 1e-2, huber_delta=2.0)[3]
                sols.append(([x.cpu().numpy() for x in (R, t, p)], float(e0),
                             float(e), acc.cpu().tolist(),
                             g.mask.cpu()))
            (sol_c, e0_c, e_c, acc_c, m_c), (sol_h, e0_h, e_h, acc_h, m_h) \
                = sols
            s, gap_r, gap_c, gap_p = gauge_gap(sol_c, sol_h)
            name = str(dt).split(".")[-1]
            out["ba_card_vs_cpu"][name] = {
                "err_after": [e_c, e_h], "scale": s, "rotation_gap": gap_r,
                "centre_gap": gap_c, "point_gap": gap_p,
                "accepts": [acc_c, acc_h]}
            log(f"  {name}: reproj {e0_c:.6f} -> {e_c:.9f} px on the card, "
                f"{e0_h:.6f} -> {e_h:.9f} on the CPU; gated masks equal "
                f"{torch.equal(m_c, m_h)}; LM accepts card {acc_c}, CPU "
                f"{acc_h}; the free scale about camera 0 {s:.9f}, then "
                f"rotation gap {gap_r:.3g}, centre gap {gap_c:.3g}, point "
                f"gap {gap_p:.3g} of max(1, |X|)")
            # float32 leaves the points of short or distant tracks, whose
            # depth the window barely fixes, to the summation order: their
            # gap is printed, and gated in float64
            same = (abs(e_c - e_h) <= err_tol and abs(s - 1.0) <= 0.05
                    and max(gap_r, gap_c) <= pose_tol
                    and (dt == torch.float32 or gap_p <= pose_tol))
            if acc_c != acc_h and dt == torch.float32:
                # c_new < c_old on costs equal to float32's resolution
                # decides differently in another summation order; the
                # paths part there, and the float64 run must agree
                log(f"  {name}: the LM accept pattern flips between the "
                    f"card and the CPU; the solutions are "
                    f"{'within' if same else 'beyond'} the gates")
            elif not (same and acc_c == acc_h):
                raise AssertionError(f"ba_solve card vs CPU in {name}")

    with phase(f"VO runner: {VO_SPLAT_FRAMES} splat frames at {SIZE}^2, "
               f"pipelined with BA and pair by pair with optical_flow"):
        from keypoint_bench_tpu_torch.datasets.registry import \
            register_preloaded
        register_preloaded("chip_smoke_vo", splat_items)
        gt_s = np.stack([p[:3, 3] for p in splat.poses])
        cfg_pipe = EvalConfig.from_yaml(os.path.join(
            ROOT, "configs", "vo_synthetic.yaml"))
        cfg_lk = EvalConfig.from_yaml(os.path.join(
            ROOT, "configs", "vo_synthetic.yaml"))
        cfg_lk.model_type, cfg_lk.task_params = "Alike", {}
        cfg_lk.matcher_params = {"type": "optical_flow",
                                 "optical_flow_params": VO_LK}
        out["runner"] = {}
        for name, cfg in (("pipelined_ba", cfg_pipe),
                          ("sequential_lk", cfg_lk)):
            cfg.data_params = {"type": "preloaded", "name": "chip_smoke_vo"}
            cfg.output_dir = os.path.join(ROOT, "output", f"chip_smoke_vo_"
                                          f"{name}")
            reset_launches()
            r = Evaluator(cfg, DEVICE).run()
            got = read_launches()
            with plain_twins():
                r_p = Evaluator(cfg, DEVICE).run()
            ates = [ate_rmse(r["t_est"][1:, :, 0], gt_s)]
            for seed in VO_SEEDS[1:]:
                cfg.seed = seed
                ates.append(ate_rmse(Evaluator(cfg, DEVICE).run()[
                    "t_est"][1:, :, 0], gt_s))
            cfg.seed = 0
            length = float(np.linalg.norm(np.diff(r_p["t_est"][:, :, 0],
                                                  axis=0), axis=1).sum())
            gap = float(np.abs(r["t_est"] - r_p["t_est"]).max())
            rec = {"ate_by_seed": ates, "ate_median": statistics.median(ates),
                   "ate_plain": ate_rmse(r_p["t_est"][1:, :, 0], gt_s),
                   "ate_bound": 2 * JAX_CPU_ATE[name], "t_gap": gap,
                   "length": length, "launches": got}
            for k in ("ba_tracks", "ba_reproj_before", "ba_reproj_after"):
                if k in r:
                    rec[k] = r[k]
            out["runner"][name] = rec
            if name == "pipelined_ba":
                pts = r["ba_points"]
                z0 = (r["ba_R_w2c"][0] @ pts.T
                      + r["ba_t_w2c"][0][:, None])[2]
                rec["front_share"] = float((z0 > 0).mean())
            log(f"  {name}: {rec}")
            if name == "pipelined_ba":
                if not (got["nms"] > 0 and got["sample"] > 0
                        and got["nn_match"] > 0):
                    raise AssertionError(f"the pipelined VO runner missed "
                                         f"kernel A, B or D: {got}")
                if not (r["ba_reproj_after"] < r["ba_reproj_before"]
                        and r["ba_tracks"] > 100
                        and rec["front_share"] > 0.95):
                    raise AssertionError("the VO runner's BA missed its "
                                         "gates")
            else:
                want_lk = VO_LK["levels"] * VO_SPLAT_FRAMES
                if got["lk"] != want_lk or got["nms"] <= 0:
                    raise AssertionError(f"the sequential VO runner "
                                         f"launches kernel F {want_lk} "
                                         f"times and A; got {got}")
            if not (gap <= 1e-3 * length
                    and rec["ate_median"] < rec["ate_bound"]):
                raise AssertionError(f"the VO runner ({name}) differs from "
                                     f"its plain twin or misses its ATE "
                                     f"bound")
        out["launches_lk"] = out["runner"]["sequential_lk"]["launches"]["lk"]
    return out


def family_model(name, dev):
    """A model of the detector family on `dev`: weights_npz/ checkpoints,
    the golden randomized parameters (GOLDEN_MODELS), or the default
    model_params (Harris, ORB, SIFT)."""
    from keypoint_bench_tpu_torch.models import get_model
    from keypoint_bench_tpu_torch.weights import (load_golden_params,
                                                  load_params)
    if name in CLASSIC_MODELS:
        return get_model(name)({})
    params = (load_golden_params(name, dev) if name in GOLDEN_MODELS
              else load_params(name, device=dev))
    return get_model(name)(params).eval()


def bits_equal(a, b):
    """Bit equality of two float32 or bfloat16 tensors (a NaN equals a NaN
    with the same bits, which torch.equal does not grant)."""
    import torch
    ints = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(ints), b.contiguous().view(ints))


def map_gap(got, want):
    """(max |got - want| over the values finite on both sides, the
    largest finite |want|, whether the NaNs sit at the same places)."""
    import torch
    fin = torch.isfinite(want) & torch.isfinite(got)
    err = float((got - want).abs()[fin].max()) if bool(fin.any()) else 0.0
    scale = float(want.abs()[fin].max()) if bool(fin.any()) else 0.0
    return err, scale, bool(torch.equal(torch.isnan(got), torch.isnan(want)))


def mm_min(a, b):
    """The library calls timed beside kernel D (the port never makes
    them): baddbmm for s, then both minima with indices."""
    import torch

    def call():
        s = torch.baddbmm((a * a).sum(-1)[..., None]
                          + (b * b).sum(-1)[:, None, :], a,
                          b.transpose(1, 2), alpha=-2.0)
        return s.min(-1), s.min(-2)
    return call


def detector_phases(dev, card, errs):
    """The detector family (phases 24-27): every model's forward on the
    card against the CPU (and the golden fixtures); `dense_extract_match`
    for the seven descriptor models at bench.py's dense shape, kernels A
    and D held on the step's own calls and against the plain-twin step,
    timed with stages; `dense_detect` for the four detectors; the sweep
    against its plain-twin run beside the JAX CPU values; LETNet's LK
    flow source through the runner (kernel F on 3-channel maps). Returns
    the numbers for the dense_extract_match and kernels JSON lines."""
    import numpy as np
    import torch

    from keypoint_bench_tpu_torch.datasets.synthetic import _texture
    from keypoint_bench_tpu_torch.models.sfd2 import stability
    from keypoint_bench_tpu_torch.ops import cuda_lk, cuda_match, cuda_nms
    from keypoint_bench_tpu_torch.ops.detect import (DetectParams,
                                                     detection_batch,
                                                     fast_nms)
    from keypoint_bench_tpu_torch.ops.grid_sample import sample_at_points
    from keypoint_bench_tpu_torch.ops.lk import _lk_level
    from keypoint_bench_tpu_torch.ops.matching import (mutual_nn_match,
                                                       nn_dists)
    from keypoint_bench_tpu_torch.pipeline import (dense_detect,
                                                   dense_extract_match)
    from keypoint_bench_tpu_torch.runner import EvalConfig, Evaluator
    from keypoint_bench_tpu_torch.sweep import run_sweep
    from keypoint_bench_tpu_torch.weights import stage_golden_weights
    from keypoint_bench_tpu_torch.weights.io import GOLDEN_DIR

    out = {"models": {}}
    t_start = time.perf_counter()
    dp = DetectParams(nms_dist=6, border_dist=8, top_k=K)
    models = {n: family_model(n, dev) for n in FAMILY}
    cpu_models = {n: family_model(n, torch.device("cpu")) for n in FAMILY}

    with phase(f"forwards: the detector family, card vs CPU at 64^2 "
               f"(golden inputs) and at {SIZE}^2"):
        rng = np.random.default_rng(0)
        big = torch.from_numpy(_texture(SIZE, SIZE, rng)[None])
        flips = {}
        for name in FAMILY:
            g = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz")) \
                if name not in CLASSIC_MODELS else None
            small = torch.from_numpy((g if g is not None else np.load(
                os.path.join(GOLDEN_DIR, "LETNet.npz")))["image"]
                .transpose(0, 2, 3, 1).copy())
            for size, img in ((64, small), (SIZE, big)):
                with torch.inference_mode():
                    s_c, d_c = models[name](img.to(dev))
                    s_p, d_p = cpu_models[name](img)
                s_c = s_c.cpu()
                keep = torch.ones_like(s_p, dtype=torch.bool)
                if name == "sfd2":
                    # the stability class may flip where the top two
                    # upsampled logits lie within float error of each
                    # other: a gap under 1e-5 of the largest |logit| (the
                    # randomized weights' logits reach ~2.5e5, where f32's
                    # spacing is 0.0156); those pixels are set aside
                    with torch.inference_mode():
                        sta_c = models[name].logits(img.to(dev))[2].cpu()
                        sta_p = cpu_models[name].logits(img)[2]
                    top2 = sta_p.topk(2, dim=1).values
                    gap = top2[:, 0] - top2[:, 1]                # [B,H,W]
                    flip = (stability(sta_c) != stability(sta_p))[:, 0]
                    thr = 1e-5 * float(sta_p.abs().max())
                    flips[size] = {
                        "flipped": int(flip.sum()),
                        "beyond_allowance": int((flip & (gap >= thr)).sum()),
                        "under_allowance": int((gap < thr).sum()),
                        "allowance": thr,
                        "flip_gaps": gap[flip].tolist()[:10],
                        "logit_max_abs_err": float(
                            (sta_c - sta_p).abs().max()),
                        "logit_max_abs": float(sta_p.abs().max())}
                    log(f"  sfd2 at {size}^2 stability: {flips[size]}")
                    if flips[size]["beyond_allowance"]:
                        raise AssertionError("sfd2: a stability flip beyond "
                                             "the allowance")
                    keep = ~flip[..., None]
                err, scale, nan_eq = map_gap(s_c[keep], s_p[keep])
                derr, dscale = 0.0, 0.0
                if d_p is not None:
                    derr, dscale, dnan = map_gap(d_c.cpu(), d_p)
                    nan_eq = nan_eq and dnan
                log(f"  {name} at {size}^2: score max abs err {err:.3g} "
                    f"(max |score| {scale:.3g}), desc {derr:.3g} (max "
                    f"{dscale:.3g}); NaN at the same places {nan_eq}"
                    + (f"; stability flips {flips[size]['flipped']}"
                       if name == "sfd2" else ""))
                # card vs CPU: f32 sums in other orders through up to 13
                # layers: 1e-4 of each map's largest value
                if not (nan_eq and err <= 1e-4 * scale
                        and derr <= 1e-4 * dscale):
                    raise AssertionError(f"{name} forward card vs CPU")
                if size == 64 and g is not None:
                    atol, rtol = GOLDEN_TOL[name]
                    np.testing.assert_allclose(
                        s_c[..., 0].numpy(), g["score"][:, 0], atol=atol,
                        rtol=rtol, err_msg=f"{name} score vs golden")
                    if d_p is not None:
                        np.testing.assert_allclose(
                            d_c.cpu().numpy(),
                            g["desc"].transpose(0, 2, 3, 1), atol=atol,
                            rtol=rtol, err_msg=f"{name} desc vs golden")
        out["sfd2_stability_flips"] = flips
        log(f"  the 8 learned models equal their golden fixtures within "
            f"tests/test_models.py's tolerances on the card")

    rng = np.random.default_rng(0)
    imgs = [torch.from_numpy(np.round(np.stack(
        [_texture(SIZE, SIZE, rng) for _ in range(DENSE_PAIRS)]) * 255)
        .astype(np.uint8)).to(dev) for _ in range(2)]

    with phase(f"dense_extract_match: {len(DESC_MODELS)} descriptor models, "
               f"{DENSE_PAIRS} pairs at {SIZE}^2 (uint8); dense_detect: "
               f"{len(DETECTOR_MODELS)} detectors"):
        for name in DESC_MODELS + DETECTOR_MODELS:
            model, rec = models[name], {}
            dense = name in DESC_MODELS

            def step(model=model, dense=dense):
                if dense:
                    return dense_extract_match(model, imgs[0], imgs[1], dp,
                                               5.0, device=DEVICE)
                return [dense_detect(model, im, dp, device=DEVICE)
                        for im in imgs]

            reset_launches()
            with recording(cuda_nms, "nms_cuda") as nms_calls, \
                    recording(cuda_match, "nn_dists_cuda") as nn_calls:
                res = step()
                torch.cuda.synchronize()
            got = read_launches()
            want_l = {"nms": 2, "nn_match": 2 if dense else 0}
            if any(got[k] != v for k, v in want_l.items()):
                raise AssertionError(f"{name}: launches {got}, want "
                                     f"{want_l}")
            rec["launches"] = {k: got[k] for k in want_l}
            for args, kw in nms_calls:
                g_, w_ = cuda_nms.nms_cuda(*args, **kw), fast_nms(*args,
                                                                  **kw)
                if not bits_equal(g_, w_):
                    raise AssertionError(f"{name}: kernel A differs from "
                                         f"fast_nms on the step's maps")
            maps = nms_calls[0][0][0]
            rec["score_nan_share"] = float(torch.isnan(maps).float().mean())
            with plain_twins():
                res_p = step()
            if dense:
                n, k0, m1 = res
                n_p, k0_p, m1_p = res_p
                (a, b), _ = nn_calls[0]
                g_, w_ = cuda_match.nn_dists_cuda(a, b), nn_dists(a, b)
                near, err_free, _ = check_nn(g_, w_, a, b)
                errs["nn_match"] = max(errs["nn_match"], err_free)
                differ01 = g_[0] != w_[0]
                n_diff = int(differ01.sum() + (g_[2] != w_[2]).sum())
                parted = ~(m1[..., :2] == m1_p[..., :2]).all(-1)
                valid = k0[..., 2] > 0
                rec.update(matches=int(n), matches_plain=int(n_p),
                           valid_kpts=int(valid.sum()),
                           near_tie_indices=near, rows_parted=int(
                               (parted & valid).sum()), desc_dim=a.shape[-1]
                           - 1)
                if not bits_equal(k0, k0_p):
                    raise AssertionError(f"{name}: k0 differs from the "
                                         f"plain-twin step")
                # a match row may part only where kernel D's pick is a near
                # tie of the plain twin's (check_nn held that above)
                if bool((parted & ~differ01).any()) or \
                        abs(int(n) - int(n_p)) > n_diff:
                    raise AssertionError(f"{name}: matches differ from the "
                                         f"plain-twin step beyond near ties")
                if not (torch.isfinite(m1[..., :2]).all()
                        and m1.shape == (DENSE_PAIRS, K, 3)):
                    raise AssertionError(f"{name}: outputs malformed")
            else:
                rec.update(valid_kpts=sum(int(r[1].sum()) for r in res))
                if not all(bits_equal(r[0], rp[0]) and torch.equal(r[1],
                                                                   rp[1])
                           for r, rp in zip(res, res_p)):
                    raise AssertionError(f"{name}: keypoints differ from "
                                         f"the plain-twin step")
            torch.cuda.reset_peak_memory_stats()
            step()
            torch.cuda.synchronize()
            rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
            windows = timed_windows(step)
            dt = statistics.median(windows)
            rec["pairs_per_s"] = DENSE_PAIRS / dt
            rec["frames_per_s"] = 2 * DENSE_PAIRS / dt
            rec["pairs_per_s_windows"] = [DENSE_PAIRS / w for w in windows]
            with torch.inference_mode():
                s0, dm0 = model(imgs[0])
                s1, dm1 = model(imgs[1])
                kk0, vv0 = detection_batch(s0, dp)
                kk1, vv1 = detection_batch(s1, dp)
                st = {"forward": cuda_ms(
                    lambda: [model(im) for im in imgs], iters=3),
                      "detection": cuda_ms(
                    lambda: [detection_batch(s, dp) for s in (s0, s1)],
                    iters=3)}
                if dense:
                    f0 = sample_at_points(dm0, kk0)
                    f1 = sample_at_points(dm1, kk1)
                    st["sampling"] = cuda_ms(lambda: (
                        sample_at_points(dm0, kk0),
                        sample_at_points(dm1, kk1)), iters=3)
                    st["mutual_nn_match (kernel D)"] = cuda_ms(
                        lambda: mutual_nn_match(f0, f1, vv0, vv1, 5.0),
                        iters=5)
            rec["stages_ms"] = st
            out["models"][name] = rec
            log(f"  {name}: {rec['pairs_per_s']:.2f} pairs/s, "
                f"{rec['frames_per_s']:.2f} frames/s (windows "
                f"{min(rec['pairs_per_s_windows']):.2f}-"
                f"{max(rec['pairs_per_s_windows']):.2f} pairs/s), peak "
                f"{rec['peak_memory_gb']:.3f} GiB, stages "
                + ", ".join(f"{k} {v:.4f} ms" for k, v in st.items())
                + "; " + ", ".join(f"{k} {v}" for k, v in rec.items() if k
                                  in ("matches", "matches_plain",
                                      "valid_kpts", "near_tie_indices",
                                      "rows_parted", "desc_dim",
                                      "score_nan_share")) + f" on {card}")
            if dense and name in ("LETNet", "D2Net"):
                out[f"nn_call_{name}"] = (a, b)
        out["launches_dense_extract_match"] = \
            out["models"]["D2Net"]["launches"]

    with phase("kernel D at the family's widths: D = 4 (LETNet) and 513 "
               "(D2Net), the steps' own inputs, in turns with baddbmm"):
        out["match_widths"] = {}
        for name in ("LETNet", "D2Net"):
            a, b = out.pop(f"nn_call_{name}")
            ms, lib_ms, turns = in_turns(
                lambda: cuda_match.nn_dists_cuda(a, b), mm_min(a, b),
                iters=20, other_iters=10)
            plain_ms = cuda_ms(lambda: nn_dists(a, b), iters=5)
            bound_ms, bound_by = match_bound(a, b)
            busy, _, _ = profile_step(
                lambda: [cuda_match.nn_dists_cuda(a, b) for _ in range(10)])
            dev_ms = busy / 10
            d = a.shape[-1]
            out["match_widths"][d] = {
                "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "bound_ms": bound_ms,
                "bound_by": bound_by}
            log(f"  D={d} ({name}, {tuple(a.shape)}): kernel {ms:.4f} ms "
                f"(device {dev_ms:.4f}), plain {plain_ms:.4f}, baddbmm + "
                f"min {lib_ms:.4f}, bound {bound_ms:.4f} ({bound_by}); "
                f"bound / device time {bound_ms / dev_ms:.3f}; in turns "
                f"{[round(t, 4) for t in turns]}")

    with phase("sweep: configs/sweep_repeatability.yaml (4 pairs at "
               "512^2) and DISK, sfd2, D2Net, ORB, SIFT, against the "
               "plain-twin sweep"):
        import yaml
        with open(os.path.join(ROOT, "configs",
                               "sweep_repeatability.yaml")) as f:
            spec = yaml.safe_load(f)
        base = dict(spec["base"], output_dir=os.path.join(
            ROOT, "output", "chip_smoke_sweep"))
        staged = dict(base, weights_dir=stage_golden_weights(os.path.join(
            ROOT, "output", "chip_smoke_sweep_weights")))
        extra = SWEEP_EXTRA

        def sweep_all():
            r = run_sweep(base, spec["models"], device=DEVICE)
            r.update(run_sweep(staged, list(extra), device=DEVICE))
            return r

        t0 = time.perf_counter()
        reset_launches()
        res = sweep_all()
        out["sweep_launches"] = read_launches()
        sweep_s = time.perf_counter() - t0
        with plain_twins():
            res_p = sweep_all()
        out["sweep"] = {}
        for m, r in res.items():
            if "error" in r:
                raise AssertionError(f"sweep {m}: {r['error']}")
            rp = res_p[m]
            out["sweep"][m] = r["repeatability"]
            log(f"  {m}: repeatability {r['repeatability']} (plain "
                f"{rp['repeatability']}, JAX CPU {JAX_CPU_SWEEP[m]}), "
                f"num_feat {r['num_feat']}, rep_mean_err "
                f"{r['rep_mean_err']}")
            if (r["repeatability"] != rp["repeatability"]
                    or r["num_feat"] != rp["num_feat"]):
                raise AssertionError(f"sweep {m} differs from the "
                                     f"plain-twin sweep")
        if set(res) != set(spec["models"]) | set(extra):
            raise AssertionError(f"sweep ran {sorted(res)}")
        log(f"  the card's sweep of {len(res)} models: {sweep_s:.1f} s; "
            f"launches {out['sweep_launches']}")

    with phase("FundamentalMatrix runner: LETNet + optical_flow on its "
               "descriptor maps, 5 frames at 512^2"):
        for pipelined in (False, True):
            cfg = EvalConfig.from_yaml(os.path.join(
                ROOT, "configs", "fund_synthetic.yaml"))
            cfg.model_type = "LETNet"
            cfg.data_params = {**cfg.data_params, "num_frames": 5,
                               "image_size": SIZE}
            cfg.task_params = {**cfg.task_params, "pipelined": pipelined}
            cfg.output_dir = os.path.join(ROOT, "output",
                                          "chip_smoke_fund_letnet")
            levels = int(cfg.matcher_params["optical_flow_params"]["levels"])
            reset_launches()
            with recording(cuda_lk, "lk_level_cuda") as lk_calls:
                res = Evaluator(cfg, DEVICE).run()
            got = read_launches()
            with plain_twins():
                res_p = Evaluator(cfg, DEVICE).run()
            lk_err, lk_far = 0.0, 0
            for args, kw in lk_calls:
                if args[0].shape[-1] != 3:
                    raise AssertionError("kernel F ran on something other "
                                         "than the 3-channel maps")
                g_ = cuda_lk.lk_level_cuda(*args, **kw)
                w_ = _lk_level(*args, **kw)
                e = (g_ - w_).abs().amax(-1)
                lk_err = max(lk_err, float(e.max()))
                lk_far += int((e > 1e-2).sum())
            n_pts = sum(a_[2].shape[0] * a_[2].shape[1] for a_, _ in lk_calls)
            e, e_p = (np.asarray(r["per_frame_error"]) for r in (res, res_p))
            log(f"  pipelined={pipelined}: per_frame_error "
                f"{np.round(e, 5).tolist()} (plain "
                f"{np.round(e_p, 5).tolist()}); fundamental_num "
                f"{res['fundamental_num']} (plain {res_p['fundamental_num']})"
                f"; launches {got}; kernel F on {len(lk_calls)} calls of "
                f"{tuple(lk_calls[0][0][0].shape)} maps: max abs err "
                f"{lk_err:.3g} px, {lk_far} of {n_pts} points beyond 1e-2")
            want_lk = levels * (1 if pipelined else 5)
            if got["lk"] != want_lk or got["nms"] <= 0:
                raise AssertionError(f"the LETNet run missed kernel F or A: "
                                     f"{got}")
            if lk_far > 0.01 * n_pts:
                raise AssertionError("kernel F differs from _lk_level on "
                                     "the descriptor maps")
            if not (np.isfinite(e).all() and len(e) == 5
                    and (np.abs(e - e_p) <= 1e-3 * np.abs(e_p) + 1e-5).all()
                    and abs(res["fundamental_num"] - res_p["fundamental_num"])
                    <= 0.005 * K):
                raise AssertionError("the LETNet FundamentalMatrix run "
                                     "differs from the plain twins")
            out["launches_fund_letnet_lk"] = {k: got[k] for k in ("nms",
                                                                  "lk")}
            errs["lk"] = max(errs["lk"], lk_err)
    out["seconds"] = time.perf_counter() - t_start
    log(f"the detector family's phases: {out['seconds']:.1f} s")
    return out


# bf16 mode (phases 28-31): the card-vs-CPU gate of the bf16 forwards, and
# the phases themselves
# (cap ulps, share beyond 4 ulps) of the score and the descriptor map of
# each weighted model's bf16 forward, card against CPU: twice
# tests/test_torch_bf16_models.py's bounds (port against JAX on the CPU)
BF16_TOL = {
    "Alike": ((24, 0.006), (12, 0.001)),
    "SuperPoint": ((512, 0.004), (8, 0.001)),
    "XFeat": ((80, 0.04), (20, 0.002)),
    "EdgePoint": ((8, 0.001), (12, 0.001)),
    "GoodPoint": ((8, 0.001), (8, 0.001)),
    "LETNet": ((40, 0.01), (8, 0.001)),
    "KeyNet": ((8, 0.001), None),
    "r2d2": ((20, 0.002), (12, 0.002)),
    "DISK": ((56, 0.12), (16, 0.002)),
    "sfd2": ((8, 0.001), (12, 0.001)),
    "D2Net": ((12, 0.002), (8, 0.001)),
}
BF16_DENSE = ("r2d2", "DISK", "D2Net")   # the forwards that lead (PERF.md)
# a bf16 step against its f32 run: repeatability and its mean error in px
# (tests/test_precision.py's bounds), the keypoint sets' Jaccard overlap,
# the mean epipolar error in px, a match or inlier count's share
# (tests/test_torch_bf16_steps.py's COUNT_REL), the VO ATE's ratio (the
# VO runner's rule against the JAX runner, phase 22)
BF16_SHIFT, BF16_JACCARD, BF16_EPI = (0.02, 0.05), 0.7, 0.05
BF16_COUNT, BF16_ATE = 0.15, 2.0


def bf16_ulps(got, want):
    """(max, share beyond 4) of |got - want| in bf16 ulps of want's
    largest finite magnitude (2^(floor(log2 max) - 7)), over the values
    finite on both sides; a map of zeros must be matched exactly."""
    import math

    import torch
    g, w = got.double().cpu(), want.double().cpu()
    fin = torch.isfinite(g) & torch.isfinite(w)
    top = float(w[fin].abs().max()) if bool(fin.any()) else 0.0
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 1e-38
    e = (g - w).abs()[fin] / ulp
    return (float(e.max()) if e.numel() else 0.0,
            float((e > 4).double().mean()) if e.numel() else 0.0)


def device_turns(fn, other, calls=20):
    """(device ms a call of fn, of other, the four readings): the
    profiler's device time of `calls` calls, in turns fn, other, other,
    fn, each the mean of its two."""
    t = []
    for f in (fn, other, other, fn):
        busy, _, _ = profile_step(lambda: [f() for _ in range(calls)])
        t.append(busy / calls)
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t


def homography_repeatability(k0, v0, k1, v1, items, th=3.0):
    """The runner's repeatability of B detections on homography pairs
    (`tasks.repeatability.repeatability_pair` on each): (mean
    repeatability, mean of the finite mean errors)."""
    import numpy as np

    from keypoint_bench_tpu_torch.geometry.warp import warp_points
    from keypoint_bench_tpu_torch.tasks.repeatability import \
        repeatability_pair
    reps, errs_ = [], []
    for i, it in enumerate(items):
        wp01, wp10 = it["warp01_params"], it["warp10_params"]
        a0, a01, va = warp_points(k0[i], v0[i], wp01)
        b0, b10, vb = warp_points(k1[i], v1[i], wp10)
        out = repeatability_pair(k0[i], v0[i], k1[i], v1[i], a0, a01, va, b0,
                                 b10, vb, float(wp01.get("resize",
                                                         wp01["width"])), th)
        reps.append(float(out["repeatability"]))
        errs_.append(float(out["mean_error"]))
    e = np.asarray(errs_)
    return float(np.mean(reps)), float(np.mean(e[~np.isnan(e)]))


def keypoint_jaccard(k_a, v_a, k_b, v_b, h, w):
    """Per image, |A & B| / |A | B| of the valid keypoints' pixels."""
    import torch
    size = torch.tensor([w, h], device=k_a.device)
    out = []
    for ka, va, kb, vb in zip(k_a, v_a, k_b, v_b):
        a = {tuple(p) for p in torch.round(ka[va][:, :2] * size - 0.5)
             .long().tolist()}
        b = {tuple(p) for p in torch.round(kb[vb][:, :2] * size - 0.5)
             .long().tolist()}
        out.append(len(a & b) / max(len(a | b), 1))
    return out


def bf16_phases(dev, card, errs, ctx):
    """bf16 mode, bench.py's default precision (phases 28-31): the bf16
    forwards card vs CPU; kernel B's bf16 instantiation against its plain
    version, timed beside the f32 instantiation and its bounds; every step
    in bf16 at 512^2 with its launch counts read, gated against its
    plain-twin run and against its f32 run, timed in turns with it; the
    runners on configs/repeatability_synthetic.yaml and the AUC config
    with precision bfloat16. `ctx` holds the f32 phases' data, models and
    runner results. Returns the numbers for the bf16 and kernels JSON
    lines."""
    from dataclasses import replace

    import numpy as np
    import torch

    from keypoint_bench_tpu_torch.models import get_model
    from keypoint_bench_tpu_torch.models.common import (cast_params_bf16,
                                                        to_float_image)
    from keypoint_bench_tpu_torch.ops import cuda_sample
    from keypoint_bench_tpu_torch.ops.detect import (DetectParams,
                                                     detection_batch)
    from keypoint_bench_tpu_torch.ops.sparse_desc import (row_tap_keys,
                                                          sample_branches)
    from keypoint_bench_tpu_torch.pipeline import (
        dense_detect, dense_extract_match, extract, extract_match,
        lk_fundamental_step, superpoint_mha_step, vo_step, xfeat_auc_step)
    from keypoint_bench_tpu_torch.runner import EvalConfig, Evaluator
    from keypoint_bench_tpu_torch.tasks.trajectory import ate_rmse
    from keypoint_bench_tpu_torch.weights import (load_golden_params,
                                                  load_params)

    bf = torch.bfloat16
    out = {"steps": {}}
    t_start = time.perf_counter()
    dp = DetectParams(nms_dist=6, border_dist=8, top_k=K)
    imgs0, imgs1, items = ctx["imgs0"], ctx["imgs1"], ctx["items"]

    def weights(name, device, precision="bfloat16"):
        gold = name in ("SuperPoint", "XFeat") + GOLDEN_MODELS
        p = (load_golden_params(name, device) if gold
             else load_params(name, device=device))
        return cast_params_bf16(p) if precision == "bfloat16" else p

    def bf_model(name, device=dev):
        return get_model(name)(weights(name, device)).eval()

    with phase("bf16 forwards: every weighted model, card vs CPU at 64^2"):
        img = torch.from_numpy(np.random.default_rng(0).random(
            (1, 64, 64, 3), np.float32))
        gaps = {}
        for name, ((sc, sf), dtol) in BF16_TOL.items():
            with torch.inference_mode():
                s_g, d_g = bf_model(name)(img.to(dev))
                s_c, d_c = bf_model(name, torch.device("cpu"))(img)
            rec = {"score": bf16_ulps(s_g, s_c)}
            ok = (s_g.dtype == s_c.dtype and rec["score"][0] <= sc
                  and rec["score"][1] <= sf)
            if name == "sfd2":
                parted = float((torch.isnan(s_g.cpu()) != torch.isnan(s_c))
                               .float().mean())
                rec["nan_parted"] = parted
                ok = ok and parted <= 0.01
            if dtol is not None:
                rec["desc"] = bf16_ulps(d_g, d_c)
                ok = ok and (d_g.dtype == d_c.dtype
                             and rec["desc"][0] <= dtol[0]
                             and rec["desc"][1] <= dtol[1])
            gaps[name] = rec
            log(f"  {name}: {s_g.dtype} score {rec['score'][0]:.2f} ulps "
                f"(share beyond 4: {rec['score'][1]:.5f}; cap {sc}, {sf})"
                + ("" if dtol is None else
                   f", {d_g.dtype} desc {rec['desc'][0]:.2f} ulps "
                   f"({rec['desc'][1]:.5f}; cap {dtol[0]}, {dtol[1]})")
                + (f", NaN parted {rec['nan_parted']:.4f}"
                   if "nan_parted" in rec else ""))
            if not ok:
                raise AssertionError(f"{name} bf16 forward card vs CPU: "
                                     f"{rec}")
        out["forward_ulps_card_vs_cpu"] = gaps

    params = weights("Alike", dev)
    model = get_model("Alike")(params).eval()
    with torch.inference_mode():
        score0, feats0 = model.feats(imgs0)
        kpts0, valid0 = detection_batch(score0, dp)
    if not all(f.dtype == bf for f in feats0) or score0.dtype != bf:
        raise AssertionError("ALIKE-t's bf16 feats are not bf16")

    with phase("kernel B bf16 instantiation vs plain sampler (ALIKE-t's "
               "bf16 branch maps, 16 maps, K=1000)"):
        px = (kpts0[..., 0] * (SIZE - 1.0)).contiguous()
        py = (kpts0[..., 1] * (SIZE - 1.0)).contiguous()
        order = torch.sort(row_tap_keys(kpts0, SIZE), dim=1, stable=True)[1]
        pxs, pys = px.gather(1, order), py.gather(1, order)
        err = 0.0
        for name, (x, y) in (("original order", (px, py)),
                             ("y-sorted order", (pxs, pys))):
            got = cuda_sample.sample_cuda(feats0, x, y, SIZE, SIZE)
            want = sample_branches(feats0, x, y, SIZE, SIZE)
            rel = float((got - want).abs().max() / want.abs().max())
            err = max(err, float((got - want).abs().max()))
            log(f"  {name}: max abs err {float((got - want).abs().max()):.3g}"
                f", {rel:.3g} of the largest sample")
            if not rel <= 1e-5:
                raise AssertionError(f"kernel B bf16 differs ({name}): {rel}")
        feats32 = tuple(f.float() for f in feats0)
        ms, ms32, turns = in_turns(
            lambda: cuda_sample.sample_cuda(feats0, pxs, pys, SIZE, SIZE),
            lambda: cuda_sample.sample_cuda(feats32, pxs, pys, SIZE, SIZE),
            iters=20, other_iters=20)
        ms_orig = cuda_ms(lambda: cuda_sample.sample_cuda(
            feats0, px, py, SIZE, SIZE))
        plain_ms = cuda_ms(lambda: sample_branches(feats0, pxs, pys, SIZE,
                                                   SIZE), iters=3, warmup=1)
        bound_ms, bound_by = sample_bound(feats0, pxs, pys, SIZE, SIZE)
        sector_ms, sector_by, sector_bytes = sample_sector_bound(
            feats0, pxs, pys, SIZE, SIZE)
        dev_t = {}
        dev_t["bf16"], dev_t["f32"], dev_turns = device_turns(
            lambda: cuda_sample.sample_cuda(feats0, pxs, pys, SIZE, SIZE),
            lambda: cuda_sample.sample_cuda(feats32, pxs, pys, SIZE, SIZE))
        busy, _, _ = profile_step(lambda: [cuda_sample.sample_cuda(
            feats0, px, py, SIZE, SIZE) for _ in range(20)])
        dev_t["bf16 original"] = busy / 20
        log(f"  [16 maps, K={K}, y-sorted]: bf16 kernel {ms:.4f} ms, f32 "
            f"kernel on the same values {ms32:.4f} ms (in turns bf16, f32, "
            f"f32, bf16: {[round(t, 4) for t in turns]}); device time a "
            f"call in turns bf16, f32, f32, bf16 "
            f"{[round(t, 4) for t in dev_turns]}: bf16 "
            f"{dev_t['bf16']:.4f} ms, original order "
            f"{dev_t['bf16 original']:.4f} ms (events {ms_orig:.4f}), f32 "
            f"{dev_t['f32']:.4f} ms; plain {plain_ms:.4f} ms; bound "
            f"{bound_ms:.4f} ms ({bound_by}; distinct values), sector bound "
            f"{sector_ms:.4f} ms ({sector_by}; {sector_bytes} bytes of "
            f"32-byte bf16 feature sectors) on {card}")
        out["sample_bf16"] = {
            "max_abs_err": err, "ms": ms, "f32_ms_same_values": ms32,
            "device_ms": dev_t["bf16"], "f32_device_ms": dev_t["f32"],
            "ms_original_order": ms_orig,
            "device_ms_original_order": dev_t["bf16 original"],
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "sector_bound_ms": sector_ms, "sector_bound_by": sector_by}

    def rates(step, step32, n, unit, per_window=3):
        """The bf16 step's rate and its f32 run's (`n` items a step), timed
        in turns in one call with their windows, and each one's device
        busy time, host window, device activities and top kernels under
        the profiler."""
        w, w32 = timed_in_turns(step, step32, per_window=per_window)
        rec = {unit: n / statistics.median(w),
               f"{unit}_windows": [n / x for x in w],
               f"f32_{unit}": n / statistics.median(w32),
               f"f32_{unit}_windows": [n / x for x in w32]}
        for pre, f in (("", step), ("f32_", step32)):
            busy, span, top, count = profile_step(f, top=4, count=True)
            rec.update({f"{pre}device_busy_ms": busy,
                        f"{pre}host_window_ms": span,
                        f"{pre}device_activities": count,
                        f"{pre}top_kernels": [(k[:60], round(t, 4))
                                              for k, t in top]})
        return rec

    def forward_turns(fwd, fwd32, iters=5):
        with torch.inference_mode():
            ms, ms32, _ = in_turns(fwd, fwd32, iters=iters,
                                   other_iters=iters)
        return {"forward_ms": ms, "f32_forward_ms": ms32}

    def shifted(rep, rep32, err, err32):
        """True if the repeatability or its mean error moved beyond
        BF16_SHIFT from the f32 run's."""
        return not (abs(rep - rep32) < BF16_SHIFT[0]
                    and abs(err - err32) < BF16_SHIFT[1])

    def count_moved(n, n32):
        """True if a count moved beyond BF16_COUNT of the f32 run's."""
        return abs(int(n) - int(n32)) > BF16_COUNT * max(int(n32), 20)

    def gate_steps(name, rec):
        log(f"  {name}: " + "; ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in rec.items()))
        out["steps"][name] = rec

    with phase(f"bf16 extract_match: {PAIRS} pairs at {SIZE}^2 (the main "
               f"path in bf16)"):
        reset_launches()
        n, k0, m1 = extract_match(model, params, imgs0, imgs1, dp, 5.0,
                                  device=DEVICE)
        torch.cuda.synchronize()
        got = read_launches()
        log(f"  launches in one run: {got}")
        want_l = {"nms": 2, "sample_bf16": 2, "nn_match": 2, "sample": 0}
        if any(got[k] != v for k, v in want_l.items()):
            raise AssertionError(f"bf16 extract_match launches {got}, want "
                                 f"{want_l}")
        out["launches"] = {k: got[k] for k in want_l}
        with torch.inference_mode():
            ext_k = [extract(model, params, im, dp) for im in (imgs0, imgs1)]
            with plain_twins():
                ext_p = [extract(model, params, im, dp)
                         for im in (imgs0, imgs1)]
                n_p, k0_p, _ = extract_match(model, params, imgs0, imgs1, dp,
                                             5.0, device=DEVICE)
        n_valid = int(sum(e[2].sum() for e in ext_k))
        for (dk, kk, vk), (dp_, kp, vp) in zip(ext_k, ext_p):
            if not (torch.equal(kk, kp) and torch.equal(vk, vp)):
                raise AssertionError("bf16 keypoints differ from plain")
        if not (torch.equal(k0, k0_p)
                and abs(int(n) - int(n_p)) <= 0.005 * n_valid / 2
                and bool(torch.isfinite(m1).all())):
            raise AssertionError(f"bf16 extract_match vs plain: {int(n)} vs "
                                 f"{int(n_p)}")
        rep, rep_err = homography_repeatability(
            ext_k[0][1], ext_k[0][2], ext_k[1][1], ext_k[1][2], items)
        m32, p32 = ctx["model"], ctx["params"]
        with torch.inference_mode():
            e32 = [extract(m32, p32, im, dp) for im in (imgs0, imgs1)]
        n32 = int(extract_match(m32, p32, imgs0, imgs1, dp, 5.0,
                                device=DEVICE)[0])
        rep32, rep_err32 = homography_repeatability(
            e32[0][1], e32[0][2], e32[1][1], e32[1][2], items)
        jac = keypoint_jaccard(ext_k[0][1], ext_k[0][2], e32[0][1],
                               e32[0][2], SIZE, SIZE)
        rec = rates(
            lambda: extract_match(model, params, imgs0, imgs1, dp, 5.0,
                                  device=DEVICE),
            lambda: extract_match(m32, p32, imgs0, imgs1, dp, 5.0,
                                  device=DEVICE), 2 * PAIRS, "frames_per_s")
        rec.update(forward_turns(lambda: model.feats(imgs0),
                                 lambda: m32.feats(imgs0)))
        rec.update({"matches": int(n), "matches_plain": int(n_p),
                    "matches_f32": n32, "repeatability": rep,
                    "repeatability_f32": rep32, "rep_mean_err": rep_err,
                    "rep_mean_err_f32": rep_err32,
                    "keypoint_jaccard_vs_f32_min": min(jac)})
        gate_steps("extract_match", rec)
        if shifted(rep, rep32, rep_err, rep_err32):
            raise AssertionError("bf16 extract_match's repeatability moved "
                                 "beyond test_precision.py's bounds")

    with phase(f"bf16 superpoint_mha_step: brute force, {PAIRS} pairs at "
               f"{SIZE}^2"):
        sp, sp32 = bf_model("SuperPoint"), ctx["sp_model"]
        args = (imgs0, imgs1, ctx["Hs"], ctx["Hinvs"], dp)

        def mha(m=sp, seed=0):
            return superpoint_mha_step(
                m, *args, torch.Generator(device=dev).manual_seed(seed),
                "brute_force", None, 5.0, 512, device=DEVICE)

        reset_launches()
        hits, m0, m1, ok = mha()
        torch.cuda.synchronize()
        got = read_launches()
        if got["nms"] != 2 or got["nn_match"] != 2:
            raise AssertionError(f"bf16 MHA step launches {got}")
        with plain_twins():
            hits_p, m0_p, _, ok_p = mha()
        with torch.inference_mode():
            det = [detection_batch(sp(im)[0], dp) for im in (imgs0, imgs1)]
            det32 = [detection_batch(sp32(im)[0], dp)
                     for im in (imgs0, imgs1)]
        n_valid = int(det[0][1].sum() + det[1][1].sum())
        if not (torch.equal(m0, m0_p) and abs(int(ok.sum()) - int(ok_p.sum()))
                <= 0.005 * n_valid / 2):
            raise AssertionError("bf16 MHA step vs plain twins")
        rep, rep_err = homography_repeatability(*det[0], *det[1], items)
        rep32, rep_err32 = homography_repeatability(*det32[0], *det32[1],
                                                    items)
        hits32, _, _, ok32 = mha(sp32)
        rec = rates(mha, lambda: mha(sp32), PAIRS, "pairs_per_s")
        rec.update({"matches": int(ok.sum()), "matches_plain": int(ok_p.sum()),
                    "matches_f32": int(ok32.sum()),
                    "mha": hits.float().mean(0).tolist(),
                    "mha_f32": hits32.float().mean(0).tolist(),
                    "repeatability": rep, "repeatability_f32": rep32,
                    "rep_mean_err": rep_err, "rep_mean_err_f32": rep_err32})
        gate_steps("superpoint_mha_step", rec)
        if shifted(rep, rep32, rep_err, rep_err32):
            raise AssertionError("bf16 SuperPoint's repeatability moved "
                                 "beyond test_precision.py's bounds")

    with phase(f"bf16 dense_extract_match: {', '.join(BF16_DENSE)}, "
               f"{DENSE_PAIRS} pairs at {SIZE}^2"):
        h0, h1 = imgs0[:DENSE_PAIRS], imgs1[:DENSE_PAIRS]
        for name in BF16_DENSE:
            mb = bf_model(name)
            m32 = get_model(name)(weights(name, dev, "float32")).eval()

            def step(m=mb):
                return dense_extract_match(m, h0, h1, dp, 5.0, device=DEVICE)

            reset_launches()
            n, k0, _ = step()
            torch.cuda.synchronize()
            got = read_launches()
            if got["nms"] != 2 or got["nn_match"] != 2:
                raise AssertionError(f"bf16 {name} step launches {got}")
            with plain_twins():
                n_p, k0_p, _ = step()
            with torch.inference_mode():
                det = [dense_detect(mb, im, dp, device=DEVICE)[:2]
                       for im in (h0, h1)]
                det32 = [dense_detect(m32, im, dp, device=DEVICE)[:2]
                         for im in (h0, h1)]
            n_valid = int(det[0][1].sum() + det[1][1].sum())
            if not (bits_equal(k0, k0_p) and abs(int(n) - int(n_p))
                    <= 0.005 * n_valid / 2 + 1):
                raise AssertionError(f"bf16 {name} step vs plain twins")
            rep, rep_err = homography_repeatability(*det[0], *det[1],
                                                    items[:DENSE_PAIRS])
            rep32, rep_err32 = homography_repeatability(
                *det32[0], *det32[1], items[:DENSE_PAIRS])
            n32 = int(step(m32)[0])
            rec = rates(step, lambda: step(m32), DENSE_PAIRS, "pairs_per_s")
            rec.update(forward_turns(lambda: mb(h0), lambda: m32(h0),
                                     iters=3))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            step()
            torch.cuda.synchronize()
            rec.update({"peak_memory_gb":
                        torch.cuda.max_memory_allocated() / 2 ** 30,
                        "matches": int(n), "matches_plain": int(n_p),
                        "matches_f32": n32, "repeatability": rep,
                        "repeatability_f32": rep32, "rep_mean_err": rep_err,
                        "rep_mean_err_f32": rep_err32})
            gate_steps(f"dense_extract_match {name}", rec)
            if shifted(rep, rep32, rep_err, rep_err32):
                raise AssertionError(f"bf16 {name}'s repeatability moved "
                                     f"beyond test_precision.py's bounds")

    with phase(f"bf16 lk_fundamental_step: {LK_PAIRS} pairs at {SIZE}^2"):
        lk_imgs0, lk_imgs1, lk_Fs, lk = ctx["lk"]

        def lk_step(m=model, p=params):
            return lk_fundamental_step(
                m, p, lk_imgs0, lk_imgs1, lk_Fs,
                torch.Generator(device=dev).manual_seed(0), dp, lk,
                device=DEVICE)

        reset_launches()
        res, k0, v0, tracked = lk_step()
        torch.cuda.synchronize()
        got = read_launches()
        if got["nms"] != 1 or got["lk"] != lk.levels:
            raise AssertionError(f"bf16 LK step launches {got}")
        with plain_twins():
            res_p, k0_p, v0_p, _ = lk_step()
        res32, k32, v32, _ = lk_step(ctx["model"], ctx["params"])
        e, e_p, e32 = (r["fundamental_error"] for r in (res, res_p, res32))
        jac = keypoint_jaccard(k0, v0, k32, v32, SIZE, SIZE)
        if not (torch.equal(k0, k0_p) and torch.equal(v0, v0_p)
                and bool((torch.abs(e - e_p) <= 1e-3 * e_p.abs() + 1e-5)
                         .all())):
            raise AssertionError("bf16 LK step vs plain twins")
        rec = rates(lk_step, lambda: lk_step(ctx["model"], ctx["params"]),
                    LK_PAIRS, "frames_per_s")
        with torch.inference_mode():
            lk_f = to_float_image(torch.as_tensor(lk_imgs0, device=dev))
        rec.update(forward_turns(lambda: model(lk_f),
                                 lambda: ctx["model"](lk_f)))
        rec.update({"fundamental_error": float(e.mean()),
                    "fundamental_error_f32": float(e32.mean()),
                    "fundamental_num": res["fundamental_num"].tolist(),
                    "fundamental_num_f32": res32["fundamental_num"].tolist(),
                    "keypoint_jaccard_vs_f32_min": min(jac)})
        gate_steps("lk_fundamental_step", rec)
        if not (abs(rec["fundamental_error"]
                    - rec["fundamental_error_f32"]) < BF16_EPI
                and min(jac) >= BF16_JACCARD):
            raise AssertionError("bf16 LK step moved from its f32 run")

    with phase(f"bf16 xfeat_auc_step: {AUC_PAIRS} pairs at {SIZE}^2, n_hyp "
               f"{AUC_NHYP}"):
        a0, a1, Ks, poses, lg = ctx["auc"]
        xf = bf_model("XFeat")
        xf32 = get_model("XFeat")(weights("XFeat", dev, "float32")).eval()

        def auc_step(m=xf):
            return xfeat_auc_step(
                m, lg, a0, a1, Ks, poses, dp,
                torch.Generator(device=dev).manual_seed(0), AUC_NHYP,
                device=DEVICE)

        reset_launches()
        err, n_in, k0, k1, _, mask = auc_step()
        torch.cuda.synchronize()
        got = read_launches()
        if got["nms"] != 2 or got["attention"] != 18:
            raise AssertionError(f"bf16 AUC step launches {got}")
        with plain_twins():
            err_p, _, k0_p, k1_p, _, _ = auc_step()
        if not (torch.equal(k0, k0_p) and torch.equal(k1, k1_p)
                and bool(((err - err_p).abs() <= 1e-3).all())):
            raise AssertionError("bf16 AUC step vs plain twins")
        err32, n_in32, k32, _, _, mask32 = auc_step(xf32)
        jac = keypoint_jaccard(k0, k0[..., 2] > 0, k32, k32[..., 2] > 0,
                               SIZE, SIZE)
        rec = rates(auc_step, lambda: auc_step(xf32), AUC_PAIRS,
                    "pairs_per_s")
        rec.update({"matches": int(mask.sum()),
                    "matches_f32": int(mask32.sum()),
                    "inliers": n_in.tolist(), "inliers_f32": n_in32.tolist(),
                    "pose_error_deg": err.tolist(),
                    "pose_error_deg_f32": err32.tolist(),
                    "keypoint_jaccard_vs_f32_min": min(jac)})
        gate_steps("xfeat_auc_step", rec)
        # LightGlue's randomized weights match no keypoint in either run
        # (180 degrees a pair, 0 inliers): the pose path in bf16 is held
        # on the AUC runner's matches below
        if (min(jac) < BF16_JACCARD or count_moved(mask.sum(), mask32.sum())
                or not bool(torch.isfinite(err).all())):
            raise AssertionError("bf16 AUC step moved from its f32 run")

    with phase(f"bf16 AUC runner: ALIKE-t + brute force, 4 SE3 pairs at "
               f"{SIZE}^2"):
        cfg = replace(ctx["auc_cfg"], precision="bfloat16",
                      output_dir=os.path.join(ROOT, "output",
                                              "chip_smoke_auc_bf16"))
        reset_launches()
        res = Evaluator(cfg, DEVICE).run()
        got = read_launches()
        with plain_twins():
            res_p = Evaluator(cfg, DEVICE).run()
        run32 = ctx["auc_runner"]
        e, e_p = (np.asarray(r["per_pair_error"]) for r in (res, res_p))
        rec = {"per_pair_error": e.tolist(),
               "per_pair_error_plain": e_p.tolist(),
               "per_pair_error_f32": run32["per_pair_error"],
               "AUC@20": res["AUC@20"], "AUC@20_f32": run32["AUC@20"],
               "inliers": res["AUC_inliers"],
               "inliers_f32": run32["AUC_inliers"],
               "launches": {k: got[k] for k in ("nms", "nn_match")}}
        gate_steps("runner AUC", rec)
        # the f32 runner's own gates, and its inlier count within
        # BF16_COUNT
        if not (got["nms"] > 0 and got["nn_match"] > 0
                and np.median(e) < 10.0 and res["AUC@20"] > 0.3
                and np.abs(e - e_p).max() <= 1e-3
                and not count_moved(res["AUC_inliers"],
                                    run32["AUC_inliers"])):
            raise AssertionError("bf16 AUC runner vs plain twins or its f32 "
                                 "run")

    with phase(f"bf16 vo_step: {VO_FRAMES} frames at {SIZE}^2, n_hyp "
               f"{VO_NHYP}"):
        frames, K_cam, scales, gt = ctx["vo"]
        vm = get_model("Alike_s2d")(weights("Alike", dev)).eval()
        vm32 = get_model("Alike_s2d")(ctx["params"])

        def vo(m=vm):
            return vo_step(m, frames, K_cam, scales, dp,
                           torch.Generator(device=dev).manual_seed(0),
                           VO_MAXD, VO_NHYP, device=DEVICE)

        reset_launches()
        res = vo()
        torch.cuda.synchronize()
        got = read_launches()
        n_chunks = -(-VO_FRAMES // 8)
        if not (got["nms"] == n_chunks and got["sample_bf16"] == n_chunks
                and got["nn_match"] == 2 and got["sample"] == 0):
            raise AssertionError(f"bf16 vo_step launches {got}")
        out["launches_vo_step"] = got["sample_bf16"]
        with plain_twins():
            res_p = vo()
        n_valid = int(res["valid"].sum())
        if not (torch.equal(res["kpts"], res_p["kpts"])
                and abs(int(res["match_mask"].sum())
                        - int(res_p["match_mask"].sum()))
                <= 0.005 * n_valid):
            raise AssertionError("bf16 vo_step vs plain twins")
        res32 = vo(vm32)
        jac = keypoint_jaccard(res["kpts"], res["valid"], res32["kpts"],
                               res32["valid"], SIZE, SIZE)
        ate, ate32 = (ate_rmse(r["t_est"][1:, :, 0], gt)
                      for r in (res, res32))
        rec = rates(vo, lambda: vo(vm32), VO_FRAMES, "frames_per_s",
                    per_window=1)
        rec.update({"matches": int(res["match_mask"].sum()),
                    "matches_plain": int(res_p["match_mask"].sum()),
                    "matches_f32": int(res32["match_mask"].sum()),
                    "pairs_ok": int(res["ok"].sum()),
                    "pairs_ok_f32": int(res32["ok"].sum()),
                    "inliers": int(res["n_inliers"].sum()),
                    "inliers_f32": int(res32["n_inliers"].sum()),
                    "ate": ate, "ate_f32": ate32,
                    "keypoint_jaccard_vs_f32_min": min(jac)})
        gate_steps("vo_step", rec)
        if not (min(jac) >= BF16_JACCARD
                and np.isfinite(res["t_est"]).all()
                and ate <= BF16_ATE * ate32
                and not count_moved(rec["inliers"], rec["inliers_f32"])
                and rec["pairs_ok"] >= rec["pairs_ok_f32"] - 1):
            raise AssertionError("bf16 vo_step moved from its f32 run")

    with phase("bf16 runner: configs/repeatability_synthetic.yaml, "
               "precision bfloat16 (4 pairs at 512^2)"):
        cfg = EvalConfig.from_yaml(os.path.join(
            ROOT, "configs", "repeatability_synthetic.yaml"))
        cfg.precision = "bfloat16"
        cfg.output_dir = os.path.join(ROOT, "output", "chip_smoke_rep_bf16")
        reset_launches()
        ev = Evaluator(cfg, DEVICE)
        res = ev.run()
        got = read_launches()
        with plain_twins():
            res_p = Evaluator(cfg, DEVICE).run()
        rep32 = ctx["rep"]
        rec = {"repeatability": res["repeatability"],
               "repeatability_plain": res_p["repeatability"],
               "repeatability_f32": rep32["repeatability"],
               "rep_mean_err": res["rep_mean_err"],
               "rep_mean_err_f32": rep32["rep_mean_err"],
               "launches": {k: got[k] for k in ("nms", "sample_bf16")}}
        gate_steps("runner repeatability", rec)
        if not (all(v.dtype == bf for v in ev.params.values()
                    if v.dim() >= 2) and got["nms"] > 0
                and res["per_pair_repeatability"]
                == res_p["per_pair_repeatability"]
                and not shifted(res["repeatability"], rep32["repeatability"],
                                res["rep_mean_err"], rep32["rep_mean_err"])):
            raise AssertionError("bf16 runner vs plain twins or its f32 run")

    errs["sample_bf16"] = out["sample_bf16"]["max_abs_err"]
    out["seconds"] = time.perf_counter() - t_start
    return out


# The file-backed datasets (phases 33-40): trees written in each
# layout the shipped configs read, at the sizes of the real datasets
HP_SIZES = ((600, 800), (700, 1000), (600, 800))   # (h, w) of v_a, v_b, i_c
HP_IMAGES = 6
KITTI_HW, KITTI_FRAMES = (376, 1241), 8
KITTI_K = ((718.856, 0.0, 607.1928), (0.0, 718.856, 185.2157),
           (0.0, 0.0, 1.0))                       # datasets/sequences.py
TARTAN_HW, TARTAN_FRAMES = (480, 640), 5
TARTAN_K = ((320.0, 0.0, 320.0), (0.0, 320.0, 240.0), (0.0, 0.0, 1.0))
PAIRS_HW, IMAGE_PAIRS = (480, 640), 4
MEGADEPTH_HW, MEGADEPTH_PAIRS = (1066, 1600), 2
EUROC_HW, EUROC_FRAMES = (480, 752), 3
RESUME_CUT = 3


def loader_tol(h, w):
    """The native loader against the numpy decode + resize_linear on an h x
    w source (tests/test_torch_native_loader.py): the loader computes its
    source coordinates in float32, resize_linear in float64 as cv2 does,
    so a weight may be off by a few float32 ulps of the coordinate."""
    return 4 * max(h, w) * 2.0 ** -24 + 1e-6

# The JAX package's runners on the CPU on the same trees
# (tools/file_configs_cpu_reference.py): repeatability and MHA@3 of the
# HPatches configs, and the median over the RANSAC / LK keys of seeds
# 0-4 of the KITTI run's ATE. The port's must lie within 0.02 of the
# first two; its median ATE below twice the third.
JAX_CPU_FILE = {"repeatability": 0.8593999981880188, "MHA@3": 1.0,
                "kitti_ate": 0.2575151013768779}


def png_bytes(img):
    """An 8-bit PNG of uint8 img [H,W] (gray) or [H,W,3] (RGB): the
    stdlib's zlib stream, scanline y filtered with type y % 5 (None, Sub,
    Up, Average, Paeth), so every decode takes all five filters."""
    import struct
    import zlib

    import numpy as np
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    a = img.reshape(h, w * c).astype(np.int32)
    lines, prev = [], np.zeros(w * c, np.int32)
    for y in range(h):
        row, f = a[y], y % 5
        left = np.concatenate([np.zeros(c, np.int32), row[:-c]])
        ul = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        p = left + prev - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - ul)
        pred = (0, left, prev, (left + prev) >> 1,
                np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, prev, ul)))[f]
        lines.append(bytes([f]) + ((row - pred) % 256).astype(
            np.uint8).tobytes())
        prev = row

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                         0 if c == 1 else 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(lines), 6))
            + chunk(b"IEND", b""))


def write_png(path, img):
    with open(path, "wb") as f:
        f.write(png_bytes(img))


def h5_bytes(datasets):
    """An HDF5 file of {name: numpy array} in the root group, as the
    library writes with libver "earliest": superblock 0, v1 object headers,
    a symbol-table root group (one B-tree leaf, one local heap, one SNOD;
    names sorted, as lookups bisect them) and contiguous datasets of
    little-endian integers or IEEE floats. Offsets and lengths are 8
    bytes."""
    import struct

    import numpy as np
    undef = b"\xff" * 8
    arrays = {k.strip("/"): np.array(v, order="C") for k, v in
              datasets.items()}
    names = sorted(arrays)
    leaf_k, internal_k = max(4, -(-len(names) // 2)), 16

    def pad8(b):
        return b + b"\0" * (-len(b) % 8)

    def message(mtype, body):
        body = pad8(body)
        return struct.pack("<HHB3x", mtype, len(body), 0) + body

    def header(*msgs):
        body = b"".join(msgs)
        return struct.pack("<BBHII4x", 1, 0, len(msgs), 1, len(body)) + body

    def datatype(dt):
        if dt.kind in "iu":
            return struct.pack("<B3sIHH", 0x10, bytes([8 * (dt.kind == "i"),
                                                       0, 0]),
                               dt.itemsize, 0, 8 * dt.itemsize)
        exp, mant, bias = {2: (5, 10, 15), 4: (8, 23, 127),
                           8: (11, 52, 1023)}[dt.itemsize]
        return struct.pack("<B3sIHHBBBBI", 0x11, bytes(
            [0x20, 8 * dt.itemsize - 1, 0]), dt.itemsize, 0,
            8 * dt.itemsize, mant, exp, 0, mant, bias)

    def dataset_header(a, data_at):
        space = struct.pack("<BBBx4x", 1, a.ndim, 0) + b"".join(
            struct.pack("<Q", d) for d in a.shape)
        return header(message(0x01, space), message(0x03, datatype(a.dtype)),
                      message(0x08, struct.pack("<BBQQ", 3, 1, data_at,
                                                a.nbytes)))

    def entry(name_offset, obj, cache=0, scratch=b"\0" * 16):
        return struct.pack("<QQI4x", name_offset, obj, cache) + scratch

    heap_data, name_off = b"\0" * 8, {}     # offset 0: the empty name
    for n in names:
        name_off[n] = len(heap_data)
        heap_data += pad8(n.encode() + b"\0")
    # superblock (96 bytes), root header (40), heap, B-tree, SNOD, then
    # each dataset's header and data
    heap_at = 96 + 40
    btree_at = heap_at + 32 + len(heap_data)
    btree_len = 24 + (4 * internal_k + 1) * 8
    snod_at = btree_at + btree_len
    snod_len = 8 + 2 * leaf_k * 40
    pos, objects, blobs = snod_at + snod_len, {}, []
    for n in names:
        a = arrays[n].astype(arrays[n].dtype.newbyteorder("<"))
        if a.dtype.kind not in "iuf":
            raise ValueError(f"{n}: dtype {a.dtype} is not written here")
        hdr = dataset_header(a, pos + len(dataset_header(a, 0)))
        objects[n] = pos
        blobs.append(hdr + pad8(a.tobytes()))
        pos += len(blobs[-1])
    stab = struct.pack("<QQ", btree_at, heap_at)
    out = (b"\x89HDF\r\n\x1a\n" + bytes([0, 0, 0, 0, 0, 8, 8, 0])
           + struct.pack("<HHIQ", leaf_k, internal_k, 0, 0) + undef
           + struct.pack("<Q", pos) + undef + entry(0, 96, 1, stab)
           + header(message(0x11, stab))
           + b"HEAP" + bytes(4) + struct.pack("<QQQ", len(heap_data), 1,
                                              heap_at + 32) + heap_data)
    btree = (b"TREE" + bytes([0, 0]) + struct.pack("<H", 1) + undef + undef
             + struct.pack("<QQQ", 0, snod_at,
                           name_off[names[-1]] if names else 0))
    snod = b"SNOD" + bytes([1, 0]) + struct.pack("<H", len(names)) + \
        b"".join(entry(name_off[n], objects[n]) for n in names)
    out += (btree.ljust(btree_len, b"\0") + snod.ljust(snod_len, b"\0")
            + b"".join(blobs))
    assert len(out) == pos
    return out


def write_h5(path, datasets):
    with open(path, "wb") as f:
        f.write(h5_bytes(datasets))


def write_ppm(path, img):
    """Binary PPM (P6), as HPatches ships them (no comment line)."""
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(img.astype("uint8").tobytes())


def to_u8(img):
    import numpy as np
    return np.round(np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


def texture(h, w, rng):
    """The synthetic datasets' texture at h x w (made at multiples of its
    8-pixel blocks, then cropped)."""
    from keypoint_bench_tpu_torch.datasets.synthetic import _texture
    return _texture(-(-h // 8) * 8, -(-w // 8) * 8, rng)[:h, :w]


def random_homography(h, w, rng, strength=1.0):
    """A viewpoint homography about the image centre: rotation, scale,
    shear, perspective and translation of HPatches' order."""
    import numpy as np
    a = rng.uniform(-0.12, 0.12) * strength
    s = 1.0 + rng.uniform(-0.1, 0.1) * strength
    A = s * np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    A = A + rng.uniform(-0.04, 0.04, (2, 2)) * strength
    H = np.eye(3)
    H[:2, :2] = A
    H[2, :2] = rng.uniform(-1.5e-4, 1.5e-4, 2) * strength
    H[:2, 2] = rng.uniform(-30, 30, 2) * strength
    c = np.array([[1, 0, w / 2], [0, 1, h / 2], [0, 0, 1.0]])
    H = c @ H @ np.linalg.inv(c)
    return H / H[2, 2]


def hpatches_tree(root, sizes=None, n_images=None, seed=0):
    """HPatches' layout: <root>/{v_a,v_b,i_c}/{1..n}.ppm and H_1_k, the k-th
    image the first warped by H_1_k (in the original pixel frame), the i_
    sequence with a brightness change instead of a warp; HP_SIZES and
    HP_IMAGES by default."""
    import numpy as np
    from keypoint_bench_tpu_torch.datasets.synthetic import _warp_image
    sizes, n_images = sizes or HP_SIZES, n_images or HP_IMAGES
    rng = np.random.default_rng(seed)
    for name, (h, w) in zip(("v_a", "v_b", "i_c"), sizes):
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        base = texture(h, w, rng)
        write_ppm(os.path.join(d, "1.ppm"), to_u8(base))
        for k in range(2, n_images + 1):
            if name.startswith("v_"):
                H = random_homography(h, w, rng)
                img = _warp_image(base, np.linalg.inv(H))
            else:
                H = np.eye(3)
                img = base * rng.uniform(0.6, 1.0) + rng.uniform(0, 0.1)
            write_ppm(os.path.join(d, f"{k}.ppm"), to_u8(img))
            np.savetxt(os.path.join(d, f"H_1_{k}"), H)
    return root


def splat_frames(h, w, K, poses_cam, seed, n_blobs=900, depth=False):
    """Frames [h,w,3] in [0,1] of the synthetic splat scene seen through K
    from the cam-from-world poses, and with depth=True their depths."""
    import numpy as np
    from keypoint_bench_tpu_torch.datasets.synthetic import _SplatScene
    rng = np.random.default_rng(seed)
    scene = _SplatScene(h, w, np.asarray(K))
    X = np.concatenate([rng.uniform(-6, 6, (n_blobs, 1)),
                        rng.uniform(-2, 2, (n_blobs, 1)),
                        rng.uniform(4, 20, (n_blobs, 1))], axis=1)
    colors = rng.uniform(0.3, 1.0, (n_blobs, 3)).astype(np.float32)
    tex = texture(h, w, rng) * 0.15
    out = [scene._render(X, colors, T[:3, :3], T[:3, 3], tex)
           for T in poses_cam]
    return out if depth else [img for img, _ in out]


def sequence_poses(n, step=(0.3, 0.02, 0.1), yaw=0.002):
    """cam-from-world poses of a camera moving along `step` a frame while
    it turns by `yaw` radians a frame about y."""
    import numpy as np
    from keypoint_bench_tpu_torch.datasets.synthetic import rodrigues
    poses = []
    for i in range(n):
        T = np.eye(4)
        T[:3, :3] = rodrigues([0.0, yaw * i, 0.0])
        T[:3, 3] = np.asarray(step) * i
        poses.append(T)
    return poses


def kitti_tree(root, frames=None, hw=None, seed=0, step=(0.3, 0.02, 0.1)):
    """KITTI odometry's layout: <root>/sequences/00/image_0/NNNNNN.png
    (8-bit gray) and <root>/poses/00.txt (world-from-cam, 12 numbers a
    line), the camera moving by `step` a frame. Returns (sequence path
    with its trailing '/', pose file)."""
    import numpy as np
    frames, hw = frames or KITTI_FRAMES, hw or KITTI_HW
    seq = os.path.join(root, "sequences", "00")
    os.makedirs(os.path.join(seq, "image_0"), exist_ok=True)
    os.makedirs(os.path.join(root, "poses"), exist_ok=True)
    poses = sequence_poses(frames, step)
    for i, img in enumerate(splat_frames(*hw, KITTI_K, poses, seed)):
        gray = (0.299 * img[..., 0] + 0.587 * img[..., 1]
                + 0.114 * img[..., 2])
        write_png(os.path.join(seq, "image_0", f"{i:06d}.png"), to_u8(gray))
    gt = os.path.join(root, "poses", "00.txt")
    with open(gt, "w") as f:
        for T in poses:
            f.write(" ".join(repr(float(v))
                             for v in np.linalg.inv(T)[:3].reshape(-1)) + "\n")
    return seq + "/", gt


def tartanair_tree(root, frames=None, hw=None, seed=0):
    """TartanAir mono's layout: <root>/mono/ME000/NNNNNN.png (RGB) and
    <root>/mono_gt/ME000.txt (x y z qx qy qz qw, world-from-cam). Returns
    (image path with its trailing '/', ground-truth file)."""
    import numpy as np
    from keypoint_bench_tpu_torch.geometry.se3 import rotmat_to_quat
    frames, hw = frames or TARTAN_FRAMES, hw or TARTAN_HW
    seq = os.path.join(root, "mono", "ME000")
    os.makedirs(seq, exist_ok=True)
    os.makedirs(os.path.join(root, "mono_gt"), exist_ok=True)
    poses = sequence_poses(frames, step=(0.15, 0.03, 0.05))
    for i, img in enumerate(splat_frames(*hw, TARTAN_K, poses, seed + 1)):
        write_png(os.path.join(seq, f"{i:06d}.png"), to_u8(img))
    gt = os.path.join(root, "mono_gt", "ME000.txt")
    with open(gt, "w") as f:
        for T in poses:
            Tw = np.linalg.inv(T)
            f.write(" ".join(repr(float(v)) for v in np.concatenate(
                [Tw[:3, 3], rotmat_to_quat(Tw[:3, :3])])) + "\n")
    return seq + "/", gt


def image_pairs_tree(root, pairs=None, hw=None, seed=0):
    """The image-pair list's layout: RGB PNG pairs (a texture and its
    warp) and <root>/file.txt with one 'a b' line a pair."""
    import numpy as np
    from keypoint_bench_tpu_torch.datasets.synthetic import _warp_image
    pairs, hw = pairs or IMAGE_PAIRS, hw or PAIRS_HW
    rng = np.random.default_rng(seed + 2)
    os.makedirs(root, exist_ok=True)
    lines = []
    for i in range(pairs):
        base = texture(*hw, rng)
        H = random_homography(*hw, rng, strength=0.7)
        a, b = (os.path.join(root, f"{i}_{k}.png") for k in "ab")
        write_png(a, to_u8(base))
        write_png(b, to_u8(_warp_image(base, np.linalg.inv(H))))
        lines.append(f"{a} {b}\n")
    path = os.path.join(root, "file.txt")
    with open(path, "w") as f:
        f.writelines(lines)
    return path


H5_FIXTURES = os.path.join(ROOT, "tests", "data", "h5")


def h5_fixture_check():
    """Every dataset that tests/data/h5/MANIFEST.json lists (files that
    h5py wrote: tools/make_h5_fixtures.py) read with datasets/h5.py and
    held equal to its .npy: dtype, shape and bytes. Returns {file:
    [dataset names]}."""
    import numpy as np

    from keypoint_bench_tpu_torch.datasets import h5
    with open(os.path.join(H5_FIXTURES, "MANIFEST.json")) as f:
        manifest = json.load(f)
    seen = {}
    for fname, entry in sorted(manifest.items()):
        with h5.File(os.path.join(H5_FIXTURES, fname)) as f:
            for name, npy in sorted(entry["datasets"].items()):
                got = f[name]
                want = np.load(os.path.join(H5_FIXTURES, npy))
                if not (got.dtype == want.dtype and got.shape == want.shape
                        and got.tobytes() == want.tobytes()):
                    raise AssertionError(f"{fname}:{name} read as "
                                         f"{got.dtype}{got.shape}, not "
                                         f"equal to {npy}")
        seen[fname] = sorted(entry["datasets"])
    if not seen:
        raise AssertionError("no HDF5 fixtures listed")
    return seen


def megadepth_tree(root, pairs=None, hw=None, seed=0, n_blobs=2400):
    """MegaDepth's layout (dataset.json, JPEG images, h5 depths and
    calibrations); each pair two views of its own splat scene, drawn as
    SyntheticSE3Dataset draws them (rotation ~0.03 rad, 0.3-0.7 m
    sideways); the h5 files by `write_h5`, the JPEGs by PIL."""
    import json

    import numpy as np
    from PIL import Image

    from keypoint_bench_tpu_torch.datasets.synthetic import (_SplatScene,
                                                             rodrigues)
    pairs, hw = pairs or MEGADEPTH_PAIRS, hw or MEGADEPTH_HW
    h, w = hw
    f = 0.9 * h
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
    scene = _SplatScene(h, w, K)
    for sub in ("imgs", "depths", "calib"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    names = []
    for i in range(pairs):
        rng = np.random.default_rng(seed + 31 * i)
        X = np.concatenate([rng.uniform(-4 * w / h, 4 * w / h, (n_blobs, 1)),
                            rng.uniform(-4, 4, (n_blobs, 1)),
                            rng.uniform(4, 20, (n_blobs, 1))], axis=1)
        colors = rng.uniform(0.3, 1.0, (n_blobs, 3)).astype(np.float32)
        R1 = rodrigues(rng.normal(0, 0.03, 3))
        t1 = np.array([rng.uniform(0.3, 0.7), rng.uniform(-0.2, 0.2),
                       rng.uniform(-0.1, 0.1)])
        tex = texture(h, w, rng) * 0.15
        for k, (R, t) in enumerate(((np.eye(3), np.zeros(3)), (R1, t1))):
            img, depth = scene._render(X, colors, R, t, tex)
            name = f"im{2 * i + k}"
            names.append(name + ".jpg")
            Image.fromarray(to_u8(img)).save(
                os.path.join(root, "imgs", names[-1]), quality=95)
            write_h5(os.path.join(root, "depths", name + ".h5"),
                     {"/depth": depth.astype("float32")})
            write_h5(os.path.join(root, "calib", f"calibration_{name}.h5"),
                     {"K": K, "R": R, "T": t})
    with open(os.path.join(root, "dataset.json"), "w") as fh:
        json.dump({"scene0": {
            "image_path": "imgs", "depth_path": "depths",
            "calib_path": "calib", "images": names,
            "tuples": [[2 * i, 2 * i + 1] for i in range(pairs)]}}, fh)
    return root


def euroc_tree(root, frames=None, hw=None, seed=0):
    """EuRoC MAV's layout: cam0 / cam1 data.csv and PNGs, the ground-truth
    CSV and an IMU CSV. Returns the root with its trailing '/'."""
    import numpy as np
    from keypoint_bench_tpu_torch.geometry.se3 import rotmat_to_quat
    frames, hw = frames or EUROC_FRAMES, hw or EUROC_HW
    K = ((435.2046959714599, 0.0, 367.4517211914062),
         (0.0, 435.2046959714599, 252.2008514404297), (0.0, 0.0, 1.0))
    poses = sequence_poses(frames, step=(0.1, 0.0, 0.02))
    imgs = splat_frames(*hw, K, poses, seed + 4)
    for cam in ("cam0", "cam1"):
        os.makedirs(os.path.join(root, cam, "data"), exist_ok=True)
        with open(os.path.join(root, cam, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n")
            for i, img in enumerate(imgs):
                ts = 10 ** 9 + i * 5 * 10 ** 7
                f.write(f"{ts},{ts}.png\n")
                write_png(os.path.join(root, cam, "data", f"{ts}.png"),
                          to_u8(img.mean(-1)))
    gtd = os.path.join(root, "state_groundtruth_estimate0")
    os.makedirs(gtd, exist_ok=True)
    with open(os.path.join(gtd, "data.csv"), "w") as f:
        f.write("#timestamp,px,py,pz,qw,qx,qy,qz\n")
        for i, T in enumerate(poses):
            Tw = np.linalg.inv(T)
            q = rotmat_to_quat(Tw[:3, :3])
            f.write(f"{10 ** 9 + i * 5 * 10 ** 7},"
                    + ",".join(repr(float(v)) for v in
                               (*Tw[:3, 3], q[3], q[0], q[1], q[2])) + "\n")
    os.makedirs(os.path.join(root, "imu0"), exist_ok=True)
    with open(os.path.join(root, "imu0", "data.csv"), "w") as f:
        f.write("#timestamp,wx,wy,wz,ax,ay,az\n")
        for k in range(10 * frames):
            f.write(f"{10 ** 9 + k * 5 * 10 ** 6},0,0.04,0,0.1,0,9.81\n")
    return root + "/"


def file_config(name, output_dir, **data_params):
    """configs/<name>.yaml with data_params updated (root, gt, ...) and
    output_dir set: the CLI overrides no config value, so a run on another
    tree reads a copy of the config."""
    import yaml
    with open(os.path.join(ROOT, "configs", f"{name}.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["data_params"] = {**cfg["data_params"], **data_params}
    cfg["output_dir"] = output_dir
    return cfg


@contextlib.contextmanager
def timed_items(cls):
    """Sum the seconds spent in cls.__getitem__ (the dataset's load) into
    the yielded list's first entry; restored on exit."""
    spent, real = [0.0], cls.__getitem__

    def timed(self, i):
        t0 = time.perf_counter()
        try:
            return real(self, i)
        finally:
            spent[0] += time.perf_counter() - t0

    cls.__getitem__ = timed
    try:
        yield spent
    finally:
        cls.__getitem__ = real


@contextlib.contextmanager
def counting_detect():
    """Count Evaluator.detect calls (one model forward each)."""
    from keypoint_bench_tpu_torch.runner import Evaluator
    calls, real = [0], Evaluator.detect

    def detect(self, image):
        calls[0] += 1
        return real(self, image)

    Evaluator.detect = detect
    try:
        yield calls
    finally:
        Evaluator.detect = real


def run_config(cfg, plain=False, dataset_cls=None):
    """Write cfg as YAML, run it through the port's CLI (on the card, or
    through the plain twins) and return (results.json, seconds, seconds in
    the dataset's __getitem__)."""
    import yaml

    from keypoint_bench_tpu_torch import cli
    os.makedirs(cfg["output_dir"], exist_ok=True)
    path = os.path.join(cfg["output_dir"], "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    load = timed_items(dataset_cls) if dataset_cls else \
        contextlib.nullcontext([0.0])
    with (plain_twins() if plain else contextlib.nullcontext()), load as spent:
        t0 = time.perf_counter()
        if cli.main(["-c", path]) != 0:
            raise AssertionError(f"the CLI failed on {path}")
        import torch
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    with open(os.path.join(cfg["output_dir"], "results.json")) as f:
        return json.load(f), secs, spent[0]


def file_phases(dev, card, errs):
    """The file-backed datasets (phases 33-40): trees written in each
    layout under a temporary directory, the shipped configs run on them
    through the port's CLI, each against its plain-twin run, the native
    loader, the resume journal, and kernels A, B, D and F at the shapes
    these configs give them."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from keypoint_bench_tpu_torch.datasets import imageio, pairs, sequences
    from keypoint_bench_tpu_torch.models import get_model
    from keypoint_bench_tpu_torch.ops import (cuda_lk, cuda_match, cuda_nms,
                                              cuda_sample)
    from keypoint_bench_tpu_torch.ops.detect import (DetectParams,
                                                     detection_batch,
                                                     fast_nms,
                                                     fast_nms_rounds)
    from keypoint_bench_tpu_torch.ops.lk import _lk_level
    from keypoint_bench_tpu_torch.ops.matching import nn_dists
    from keypoint_bench_tpu_torch.ops.sparse_desc import sample_branches
    from keypoint_bench_tpu_torch.runtime import (NativePrefetcher,
                                                  load_pnm_resized)
    from keypoint_bench_tpu_torch.tasks.trajectory import (
        ate_rmse, read_kitti_trajectory)
    from keypoint_bench_tpu_torch.weights import load_params

    def device_ms(fn, calls=10):
        """Device time of one fn() from the profiler (busy time over
        `calls` calls): at batch 1 back-to-back events time the wrappers'
        host work."""
        return profile_step(lambda: [fn() for _ in range(calls)])[0] / calls

    t_start = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="kbt_file_phases_")
    out = {"configs": {}, "shapes": {}, "launches": {}}
    rec_calls = {"nms": {}, "nn_match": {}, "lk": {}}

    def run_card(name, cfg, dataset_cls, want, recorded=()):
        """The config on the card, launch counts reset just before and read
        just after, the kernels in `recorded` recorded; then run again,
        timed warm, with the seconds its dataset's loads took. Returns
        (results, seconds, loader seconds) of the timed run."""
        reset_launches()
        with contextlib.ExitStack() as stack:
            rec = {k: stack.enter_context(recording(*{
                "nms": (cuda_nms, "nms_cuda"),
                "nn_match": (cuda_match, "nn_dists_cuda"),
                "lk": (cuda_lk, "lk_level_cuda")}[k])) for k in recorded}
            res, cold, _ = run_config(cfg)
        got = read_launches()
        for k, calls in rec.items():
            rec_calls[k][name] = calls
        bad = {k: (got[k], n) for k, n in want.items() if got[k] != n}
        timed, secs, load = run_config(cfg, dataset_cls=dataset_cls)
        log(f"  {name}: launches {got} (want {want}); {cold:.3f} s cold, "
            f"{secs:.3f} s warm, loader {load:.3f} s ({card})")
        if bad:
            raise AssertionError(f"{name}: launch counts differ: {bad}")
        out["launches"][name] = {k: got[k] for k in
                                 ("nms", "sample", "nn_match", "lk")}
        return res, secs, load

    def run_both(name, cfg, dataset_cls, want, recorded=()):
        """`run_card`, and the config through the plain twins."""
        res, secs, load = run_card(name, cfg, dataset_cls, want, recorded)
        res_p, _, _ = run_config(dict(cfg, output_dir=cfg["output_dir"]
                                      + "_plain"), plain=True)
        return res, res_p, secs, load

    try:
        with phase("native loader: P5/P6 with comments and odd sizes"):
            rng = np.random.default_rng(5)
            files = []
            for i, (h, w, c) in enumerate(((601, 803, 3), (377, 499, 1),
                                           (700, 1000, 3), (64, 37, 1))):
                img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
                p = os.path.join(tmp, f"pnm{i}.{'ppm' if c == 3 else 'pgm'}")
                with open(p, "wb") as f:
                    f.write(f"P{6 if c == 3 else 5}\n# a comment\n{w} "
                            f"{h}\n# another\n255\n".encode())
                    f.write(img.tobytes())
                files.append(p)
            gap, tol, over = 0.0, 0.0, []
            for p in files:
                src = imageio.read_image(p)
                t = loader_tol(*src.shape[:2])
                tol = max(tol, t)
                for w, h in ((512, 512), (333, 271), (1000, 37)):
                    e = float(np.abs(load_pnm_resized(p, w, h)
                                     - imageio.resize_linear(src, (w, h)))
                              .max())
                    gap = max(gap, e)
                    if e > t:
                        over.append((p, w, h, e, t))
            with NativePrefetcher(files * 2, 512, 512, n_threads=4) as pf:
                seen = []
                for idx, frame in pf:
                    seen.append(idx)
                    if not np.array_equal(frame, load_pnm_resized(
                            files[idx % 4], 512, 512)):
                        over.append(("prefetcher", idx))
            if seen != list(range(8)) or over:
                raise AssertionError(f"native loader: order {seen}, beyond "
                                     f"the tolerance or unequal: {over}")
            rates = {}
            big = [files[2]] * 32            # 700 x 1000 P6, HPatches' order
            t0 = time.perf_counter()
            for p in big:
                load_pnm_resized(p, 512, 512)
            rates["load_pnm_resized"] = len(big) / (time.perf_counter() - t0)
            for threads in (2, 4):
                t0 = time.perf_counter()
                with NativePrefetcher(big, 512, 512, n_threads=threads) as pf:
                    n = sum(1 for _ in pf)
                rates[f"prefetcher_{threads}_threads"] = \
                    n / (time.perf_counter() - t0)
            out["loader"] = {"max_abs_gap_vs_numpy": gap,
                             "images_per_s_512": rates}
            log(f"  native vs numpy decode + resize_linear: max abs gap "
                f"{gap:.3g} (tolerance up to {tol:.3g}); prefetcher (equal "
                f"to load_pnm_resized) order "
                f"{seen}; 700x1000 P6 -> 512^2 images/s: {rates} ({card})")

        hp_root = os.path.join(tmp, "hpatches")
        with phase(f"HPatches: {len(HP_SIZES)} sequences of {HP_IMAGES} "
                   f"PPM images ({HP_SIZES}); configs/"
                   f"repeatability_hpatches.yaml and mha_hpatches.yaml"):
            hpatches_tree(hp_root)
            for name, metric in (("repeatability_hpatches", "repeatability"),
                                 ("mha_hpatches", "MHA@3")):
                cfg = file_config(name, os.path.join(tmp, "out", name),
                                  root=hp_root)
                ds = pairs.HPatchesDataset(hp_root, cfg["data_params"][
                    "alteration"], cfg["data_params"]["image_size"])
                n = len(ds)
                mha = name.startswith("mha")
                res, res_p, secs, load = run_both(
                    name, cfg, pairs.HPatchesDataset,
                    {"nms": 2 * n, "sample": 0, "nn_match": 2 * n if mha
                     else 0, "lk": 0}, recorded=("nms", "nn_match"))
                per = "per_pair" if mha else "per_pair_repeatability"
                jax_v = JAX_CPU_FILE[metric]
                rec = {metric: res[metric], "plain": res_p[metric],
                       "jax_cpu": jax_v, "pairs": n,
                       "ms_per_pair": 1e3 * secs / n,
                       "loader_share": load / secs}
                out["configs"][name] = rec
                log(f"  {name}: {rec} ({card})")
                if res[per] != res_p[per]:
                    raise AssertionError(f"{name} differs from its plain "
                                         f"twin run")
                if jax_v is None or not abs(res[metric] - jax_v) <= 0.02:
                    raise AssertionError(f"{name}: {metric} {res[metric]} "
                                         f"against the JAX package's CPU "
                                         f"{jax_v}")
                if name == "repeatability_hpatches":
                    rep_full = res

        with phase("resume: repeatability_hpatches cut after "
                   f"{RESUME_CUT} pairs, then resumed"):
            sub = os.path.join(tmp, "hpatches_cut", "v_a")
            os.makedirs(sub)
            for k in range(1, RESUME_CUT + 2):
                shutil.copy(os.path.join(hp_root, "v_a", f"{k}.ppm"), sub)
                if k > 1:
                    shutil.copy(os.path.join(hp_root, "v_a", f"H_1_{k}"), sub)
            out_dir = os.path.join(tmp, "out", "resume")
            first, _, _ = run_config(file_config(
                "repeatability_hpatches", out_dir,
                root=os.path.dirname(sub)))
            with open(os.path.join(out_dir, "progress.jsonl")) as f:
                journal = [json.loads(ln) for ln in f if ln.strip()]
            cfg = dict(file_config("repeatability_hpatches", out_dir,
                                   root=hp_root), resume=True)
            reset_launches()
            with counting_detect() as forwards:
                res, _, _ = run_config(cfg)
            n = len(rep_full["per_pair_repeatability"])
            rec = {"journal_records": len(journal) - 1,
                   "forward_calls": forwards[0],
                   "remaining_pairs": n - RESUME_CUT,
                   "nms_launches": read_launches()["nms"]}
            log(f"  {rec}; resumed {res['repeatability']} against uncut "
                f"{rep_full['repeatability']}")
            if not (len(journal) == RESUME_CUT + 1 and "meta" in journal[0]
                    and first["per_pair_repeatability"]
                    == rep_full["per_pair_repeatability"][:RESUME_CUT]
                    and res["per_pair_repeatability"]
                    == rep_full["per_pair_repeatability"]
                    and res["repeatability"] == rep_full["repeatability"]
                    and forwards[0] == 2 * (n - RESUME_CUT)
                    and rec["nms_launches"] == 2 * (n - RESUME_CUT)):
                raise AssertionError(f"the resumed run differs: {rec}")
            out["resume"] = rec

        with phase(f"KITTI: {KITTI_FRAMES} gray PNG frames at {KITTI_HW}; "
                   f"configs/vo_kitti.yaml, seeds {list(VO_SEEDS)}"):
            seq, gt_path = kitti_tree(os.path.join(tmp, "kitti"))
            gt = np.stack([T[:3, 3] for T in
                           sequences._read_kitti_poses(gt_path)])
            want = {"nms": KITTI_FRAMES + 1, "sample": 0, "nn_match": 0,
                    "lk": 3 * KITTI_FRAMES}
            # against the plain twins at LK jitter distance 0, as phase 22
            # does: with the jitter, kernel F's 5e-3 px from _lk_level can
            # move a track to another minimum, and the pair solve parts
            lk0 = file_config("vo_kitti", os.path.join(tmp, "out",
                                                       "vo_kitti_lk0"),
                              root=seq, gt=gt_path)
            lk0["matcher_params"]["optical_flow_params"]["distance"] = 0
            res, res_p, _, _ = run_both("vo_kitti (LK distance 0)", lk0,
                                        sequences.KittiDataset, want)
            t = read_kitti_trajectory(res["trajectory_path"])[1]
            t_p = read_kitti_trajectory(res_p["trajectory_path"])[1]
            length = float(np.linalg.norm(np.diff(t_p, axis=0),
                                          axis=1).sum())
            t_gap = float(np.abs(t - t_p).max())
            ates = []
            for seed in VO_SEEDS:
                cfg = dict(file_config("vo_kitti", os.path.join(
                    tmp, "out", f"vo_kitti_{seed}"), root=seq, gt=gt_path),
                    seed=seed)
                if seed == 0:
                    res, secs, load = run_card(
                        "vo_kitti", cfg, sequences.KittiDataset, want,
                        recorded=("nms", "lk"))
                else:
                    res, _, _ = run_config(cfg)
                t = read_kitti_trajectory(res["trajectory_path"])[1]
                ates.append(ate_rmse(t[1:], gt))
            jax_ate = JAX_CPU_FILE["kitti_ate"]
            rec = {"ate_by_seed": ates, "ate_median": statistics.median(ates),
                   "jax_cpu_ate_median": jax_ate,
                   "t_gap_lk_distance_0": t_gap, "length": length,
                   "frames": KITTI_FRAMES,
                   "ms_per_frame": 1e3 * secs / KITTI_FRAMES,
                   "loader_share": load / secs}
            out["configs"]["vo_kitti"] = rec
            log(f"  vo_kitti: {rec} ({card})")
            if not t_gap <= 1e-3 * length:
                raise AssertionError("vo_kitti at LK distance 0 differs "
                                     "from its plain twin")
            if jax_ate is None or not rec["ate_median"] < 2 * jax_ate:
                raise AssertionError(f"vo_kitti median ATE {ates} against "
                                     f"twice the JAX package's {jax_ate}")

        with phase(f"TartanAir: {TARTAN_FRAMES} RGB PNG frames at "
                   f"{TARTAN_HW}; configs/fund_tartanair.yaml"):
            seq, gt_path = tartanair_tree(os.path.join(tmp, "tartanair"))
            cfg = file_config("fund_tartanair", os.path.join(
                tmp, "out", "fund_tartanair"), root=seq, gt=gt_path)
            res, res_p, secs, load = run_both(
                "fund_tartanair", cfg, sequences.TartanAirDataset,
                {"nms": TARTAN_FRAMES + 1, "sample": 0, "nn_match": 0,
                 "lk": 3 * TARTAN_FRAMES}, recorded=("nms", "lk"))
            e, e_p = (np.asarray(r["per_frame_error"]) for r in (res, res_p))
            rec = {"per_frame_error": e.tolist(), "plain": e_p.tolist(),
                   "fundamental_num": res["fundamental_num"],
                   "ms_per_frame": 1e3 * secs / TARTAN_FRAMES,
                   "loader_share": load / secs}
            out["configs"]["fund_tartanair"] = rec
            log(f"  fund_tartanair: {rec} ({card})")
            if not (np.isfinite(e).all() and len(e) == TARTAN_FRAMES
                    and (np.abs(e - e_p) <= 1e-3 * np.abs(e_p) + 1e-5).all()
                    and abs(res["fundamental_num"] - res_p["fundamental_num"])
                    <= 0.005 * 1000):
                raise AssertionError("fund_tartanair differs from its plain "
                                     "twin run")

        with phase(f"image pairs: {IMAGE_PAIRS} PNG pairs at {PAIRS_HW}; "
                   f"configs/long_term.yaml"):
            lst = image_pairs_tree(os.path.join(tmp, "pairs"))
            cfg = file_config("long_term", os.path.join(tmp, "out",
                                                        "long_term"), root=lst)
            res, res_p, secs, load = run_both(
                "long_term", cfg, pairs.ImagePairsDataset,
                {"nms": 2 * IMAGE_PAIRS, "sample": 0,
                 "nn_match": 2 * IMAGE_PAIRS, "lk": 0},
                recorded=("nms", "nn_match"))
            rec = {"fundamental_radio": res["fundamental_radio"],
                   "plain": res_p["fundamental_radio"],
                   "ms_per_pair": 1e3 * secs / IMAGE_PAIRS,
                   "loader_share": load / secs}
            out["configs"]["long_term"] = rec
            log(f"  long_term: {rec} ({card})")
            if not (0.0 < res["fundamental_radio"] <= 1.0 and abs(
                    res["fundamental_radio"] - res_p["fundamental_radio"])
                    <= 0.005):
                raise AssertionError("long_term differs from its plain twin")

        with phase("MegaDepth: the h5py fixtures, then configs/"
                   "auc_megadepth.yaml; EuRoC where cv2 imports"):
            fixtures = h5_fixture_check()
            log(f"  {len(fixtures)} h5py-written fixtures read equal to "
                f"their .npy arrays: {fixtures}")
            root = megadepth_tree(os.path.join(tmp, "megadepth"))
            cfg = file_config("auc_megadepth", os.path.join(
                tmp, "out", "auc_megadepth"), root=root)
            res, res_p, secs, load = run_both(
                "auc_megadepth", cfg, pairs.MegaDepthDataset,
                {"nms": 2 * MEGADEPTH_PAIRS, "sample": 0,
                 "nn_match": 2 * MEGADEPTH_PAIRS, "lk": 0},
                recorded=("nms", "nn_match"))
            e, e_p = (np.asarray(r["per_pair_error"]) for r in (res, res_p))
            rec = {"per_pair_error": e.tolist(), "plain": e_p.tolist(),
                   "AUC@20": res["AUC@20"], "pairs": MEGADEPTH_PAIRS,
                   "hw": list(MEGADEPTH_HW),
                   "ms_per_pair": 1e3 * secs / MEGADEPTH_PAIRS,
                   "loader_share": load / secs, "h5_fixtures": fixtures}
            out["configs"]["auc_megadepth"] = rec
            log(f"  auc_megadepth: {rec} ({card})")
            if not (len(e) == MEGADEPTH_PAIRS and np.isfinite(e).all()
                    and (np.abs(e - e_p) <= 1e-3).all()):
                raise AssertionError("auc_megadepth differs from its plain "
                                     "twin run")
            if importlib.util.find_spec("cv2") is None:
                log("  EuRoC did not run: cv2 not installed (its loader "
                    "undistorts with cv2.undistort)")
                out["euroc"] = {"not_run_missing": ["cv2"]}
            else:
                ds = sequences.EurocDataset(euroc_tree(os.path.join(
                    tmp, "euroc")))
                items = [ds[i] for i in range(len(ds))]
                pre = ds.imu_between(1)
                rec = {"frames": len(items),
                       "shape": list(items[0]["image0"].shape),
                       "imu_dt": float(pre["dt"])}
                out["euroc"] = rec
                log(f"  EuRoC: {rec}")
                if not (rec["shape"][1] == 736 and rec["imu_dt"] > 0
                        and all(np.isfinite(it["fundamental"]).all()
                                for it in items)
                        and bool(torch.isfinite(pre["dR"]).all())):
                    raise AssertionError(f"EuRoC loader: {rec}")

        with phase("kernels A, B, D and F at the file-backed shapes"):
            params = load_params("Alike", device=dev)
            model = get_model("Alike")(params).eval()
            dp = DetectParams(nms_dist=6, border_dist=8, top_k=1000)
            maps_by = {}
            for name in ("repeatability_hpatches", "vo_kitti",
                         "fund_tartanair", "auc_megadepth"):
                calls = rec_calls["nms"].get(name)
                if calls:
                    maps_by[name] = calls[0][0][0]
            if not (rec_calls["nms"].get("auc_megadepth")
                    and rec_calls["nn_match"].get("auc_megadepth")):
                raise AssertionError("the MegaDepth run recorded no calls "
                                     "of kernels A and D")
            for name, maps in maps_by.items():
                got = cuda_nms.nms_cuda(maps, 6, 30)
                want, rounds = fast_nms_rounds(maps, 6, 30)
                diff = float((got - want).abs().max())
                errs["nms"] = max(errs["nms"], diff)
                if not torch.equal(got, want):
                    raise AssertionError(f"kernel A differs on {name}")
                bound, by = nms_bound(maps, rounds)
                shape = "x".join(map(str, maps.shape))
                out["shapes"][f"nms {shape}"] = r = {
                    "config": name, "ms": cuda_ms(
                        lambda: cuda_nms.nms_cuda(maps, 6, 30)),
                    "device_ms": device_ms(
                        lambda: cuda_nms.nms_cuda(maps, 6, 30)),
                    "plain_ms": cuda_ms(lambda: fast_nms_rounds(maps, 6, 30),
                                        iters=3, warmup=1),
                    "bound_ms": bound, "bound_by": by,
                    "rounds": rounds.tolist(), "max_abs_err": diff}
                log(f"  kernel A [{shape}] ({name}): {r}")
            # every call of the MegaDepth run, replayed with its own
            # arguments: A bit-equal to the plain NMS, D by check_nn
            md_a, md_d = rec_calls["nms"]["auc_megadepth"], \
                rec_calls["nn_match"]["auc_megadepth"]
            for args, kw in md_a:
                kw = {k: v for k, v in kw.items() if k != "stats"}
                if not torch.equal(cuda_nms.nms_cuda(*args, **kw),
                                   fast_nms(*args, **kw)):
                    raise AssertionError("kernel A differs on a call of the "
                                         "MegaDepth run")
            md_near = [0, 0]
            for args, _ in md_d:
                a, b = (x.reshape(-1, *x.shape[-2:]) for x in args[:2])
                near, err_free, _ = check_nn(cuda_match.nn_dists_cuda(a, b),
                                             nn_dists(a, b), a, b)
                errs["nn_match"] = max(errs["nn_match"], err_free)
                md_near = [md_near[0] + near[0], md_near[1] + near[1]]
            out["megadepth_calls"] = {
                "nms": [list(c[0][0].shape) for c in md_a],
                "nn_match": [[list(x.shape) for x in c[0][:2]] for c in md_d],
                "nn_near_ties": md_near}
            log(f"  MegaDepth run's own calls held: "
                f"{out['megadepth_calls']}")
            # kernel B at batch 1 on ALIKE-t's branches of these frames:
            # no shipped config samples sparsely (the runner samples the
            # dense map), so B is held at the shapes a sparse step would
            # give it
            for name, maps in maps_by.items():
                h, w = maps.shape[-2:]
                img = torch.rand((1, h, w, 3), device=dev,
                                 generator=torch.Generator(
                                     device=dev).manual_seed(h))
                with torch.inference_mode():
                    score, feats = model.feats(img)
                    kpts, _ = detection_batch(score, dp)
                px = (kpts[..., 0] * (w - 1.0)).contiguous()
                py = (kpts[..., 1] * (h - 1.0)).contiguous()
                diff = float((cuda_sample.sample_cuda(feats, px, py, h, w)
                              - sample_branches(feats, px, py, h, w))
                             .abs().max())
                errs["sample"] = max(errs["sample"], diff)
                if not diff <= 1e-5:
                    raise AssertionError(f"kernel B differs at {h}x{w}")
                bound, by = sample_bound(feats, px, py, h, w)
                out["shapes"][f"sample 1x{h}x{w}"] = r = {
                    "branches": [list(f.shape) for f in feats],
                    "ms": cuda_ms(lambda: cuda_sample.sample_cuda(
                        feats, px, py, h, w)),
                    "device_ms": device_ms(lambda: cuda_sample.sample_cuda(
                        feats, px, py, h, w)),
                    "plain_ms": cuda_ms(lambda: sample_branches(
                        feats, px, py, h, w), iters=3, warmup=1),
                    "bound_ms": bound, "bound_by": by, "max_abs_err": diff}
                log(f"  kernel B [1x{h}x{w}]: {r}")
            for name, calls in rec_calls["nn_match"].items():
                if not calls:               # repeatability matches nothing
                    continue
                a, b = (x.reshape(-1, *x.shape[-2:]) for x in calls[0][0])
                got, want = cuda_match.nn_dists_cuda(a, b), nn_dists(a, b)
                near, err_free, _ = check_nn(got, want, a, b)
                errs["nn_match"] = max(errs["nn_match"], err_free)
                bound, by = match_bound(a, b)
                shape = "x".join(map(str, a.shape))
                out["shapes"][f"nn_match {shape} ({name})"] = r = {
                    "ms": cuda_ms(lambda: cuda_match.nn_dists_cuda(a, b)),
                    "device_ms": device_ms(
                        lambda: cuda_match.nn_dists_cuda(a, b)),
                    "plain_ms": cuda_ms(lambda: nn_dists(a, b), iters=3,
                                        warmup=1),
                    "library_ms": cuda_ms(mm_min(a, b)),
                    "bound_ms": bound, "bound_by": by, "near_ties": near,
                    "max_abs_err": err_free}
                log(f"  kernel D [{shape}] ({name}): {r}")
            for name, calls in rec_calls["lk"].items():
                pair = calls[:3]                  # one pair's three levels
                far, n_pts, lk_err = 0, 0, 0.0
                for args, kw in calls:
                    e = (cuda_lk.lk_level_cuda(*args, **kw)
                         - _lk_level(*args, **kw)).abs().amax(-1)
                    lk_err = max(lk_err, float(e.max()))
                    far += int((e > 1e-2).sum())
                    n_pts += e.numel()
                errs["lk"] = max(errs["lk"], lk_err)
                if far > 0.01 * n_pts:
                    raise AssertionError(f"kernel F differs on {name}: "
                                         f"{far} of {n_pts} beyond 1e-2 px")
                fine = max(pair, key=lambda c: c[0][0].shape[1])[0]
                imgs0 = fine[0]
                bound, by, _, _ = lk_bound(imgs0, fine[2].shape[1], fine[4],
                                           len(pair), fine[5])
                out["shapes"][f"lk_level {'x'.join(map(str, imgs0.shape))} "
                              f"({name})"] = r = {
                    "ms_3_levels": sum(cuda_ms(
                        lambda a=a, k=k: cuda_lk.lk_level_cuda(*a, **k))
                        for a, k in pair),
                    "device_ms_3_levels": device_ms(lambda: [
                        cuda_lk.lk_level_cuda(*a, **k) for a, k in pair],
                        calls=5),
                    "plain_ms_3_levels": sum(cuda_ms(
                        lambda a=a, k=k: _lk_level(*a, **k), iters=2,
                        warmup=1) for a, k in pair),
                    "bound_ms": bound, "bound_by": by,
                    "max_abs_err": lk_err, "beyond_1e-2": far,
                    "points": n_pts}
                log(f"  kernel F [{tuple(imgs0.shape)}] ({name}): {r}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_start
    log(f"the file-backed phases: {out['seconds']:.1f} s")
    return out


ADAPT_PAIRS, TRACK_PAIRS = 8, 4          # adaptive pairs; tracking pairs
# configs/fund_synthetic.yaml's LK protocol (configs/fund_tartanair.yaml's)
TRACK_LK = {"distance": 10, "win_size": 21, "levels": 3, "interation": 40}


def adaptive_attention_bound(calls):
    """(ms, bound_by) of kernel E over the calls of one adaptive pair at
    K0 = K1 (a stacked self call, then a stacked cross call, a layer):
    q, k, v and the mask read once, the output written once; 4*dh FLOPs
    per valid query and valid key of a slice (QK^T and PV) at the f32 FMA
    rate, the count this run's masks need. A self call's queries are its
    keys; a cross call's queries are the self call's before it."""
    t_bytes = t_ops = 0.0
    for j, (args, _) in enumerate(calls):
        q, k, v, kv = args[:4]
        qmask = calls[j - j % 2][0][3]
        t_bytes += (4 * (2 * q.numel() + k.numel() + v.numel())
                    + kv.numel()) / PEAK_BYTES
        nq = qmask.reshape(-1, qmask.shape[-1]).sum(-1).double()
        mk = kv.reshape(-1, kv.shape[-1]).sum(-1).double()
        t_ops += 4 * q.shape[-1] * float((nq * mk).sum()) / PEAK_F32
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def adaptive_phases(dev, card, errs, ctx):
    """Adaptive LightGlue at full width (phases 41-42): SuperPoint's
    keypoints and descriptors of the main path's first ADAPT_PAIRS pairs,
    one pair at a time, in the runner's default mode and in a pruning
    mode; kernel E on an emptied side; the MHA runner in adaptive mode.
    Returns the numbers for the kernels JSON line."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from keypoint_bench_tpu_torch.models.lightglue import (
        lightglue_forward, sample_descriptors_lg)
    from keypoint_bench_tpu_torch.models.lightglue_adaptive import \
        lightglue_forward_adaptive
    from keypoint_bench_tpu_torch.ops import cuda_attention
    from keypoint_bench_tpu_torch.ops.attention import fused_attention
    from keypoint_bench_tpu_torch.runner import EvalConfig, Evaluator

    out = {}
    sk0, sva, sdm0, sk1, svb, sdm1 = ctx["superpoint"]
    lg = ctx["lightglue"]
    # (options, descriptor scale): the runner's mode (the reference's
    # defaults) on the sampled unit descriptors, where the randomized
    # weights stop at layer 4 and prune little; and a mode that never
    # stops early, on descriptors of the golden fixture's norm (16, that of
    # its Gaussian 256-vectors), where they prune at several layers down
    # to empty sides
    modes = {"default": ({}, 1.0),
             "pruning": ({"depth_confidence": 1.1}, 16.0)}
    with torch.inference_mode():
        pairs = []
        for i in range(ADAPT_PAIRS):
            p0, p1 = sk0[i, :, :2] * (SIZE - 1.0), sk1[i, :, :2] * (SIZE - 1.0)
            pairs.append((p0, sva[i], sample_descriptors_lg(p0, sdm0[i], 8),
                          p1, svb[i], sample_descriptors_lg(p1, sdm1[i], 8)))

    def run(args, mode, plain=False):
        opts, scale = modes[mode]
        p0, v0, d0, p1, v1, d1 = args
        stats = {}
        with plain_twins() if plain else contextlib.nullcontext():
            m0, _, ok, i_fin = lightglue_forward_adaptive(
                lg, p0, v0, d0 * scale, p1, v1, d1 * scale, stats=stats,
                **opts)
        return {"m0": m0, "ok": ok, "i_fin": i_fin,
                "keep": [(int(a), int(b)) for a, b in stats["keep"]],
                "margin": min((float(m) for m in stats["margin"]),
                              default=float("inf")),
                "syncs": stats["syncs"]}

    own_calls = {}
    with phase(f"adaptive LightGlue: SuperPoint, {ADAPT_PAIRS} pairs at "
               f"{SIZE}^2, K={K}, one pair at a time, card vs plain twin"):
        for mode in modes:
            rows, e_err = [], 0.0
            for i, args in enumerate(pairs):
                reset_launches()
                with recording(cuda_attention, "attention_cuda") as calls:
                    got = run(args, mode)
                    torch.cuda.synchronize()
                n_e = read_launches()["attention"]
                want = run(args, mode, plain=True)
                for a, kw in calls:
                    e = float((cuda_attention.attention_cuda(*a, **kw)
                               - fused_attention(*a, **kw)).abs().max())
                    scale = max(1.0, float(a[2].abs().max()))
                    e_err = max(e_err, e / scale)
                    if not e <= 1e-5 * scale:
                        raise AssertionError(f"kernel E differs from "
                                             f"fused_attention on pair {i}'s "
                                             f"calls ({mode}): {e}")
                errs["attention"] = max(errs["attention"], e_err)
                if i == 0:
                    own_calls[mode] = list(calls)
                same = (got["i_fin"] == want["i_fin"]
                        and got["keep"] == want["keep"]
                        and torch.equal(got["m0"], want["m0"]))
                margin = min(got["margin"], want["margin"])
                log(f"  {mode} pair {i}: i_fin {got['i_fin']} (plain "
                    f"{want['i_fin']}); keep counts {got['keep']}; smallest "
                    f"margin {margin:.3g}; kernel E launches {n_e}; host "
                    f"reads of stop {got['syncs']}; matches "
                    f"{int(got['ok'].sum())}; equal to the plain twin {same}")
                if n_e != 2 * got["i_fin"]:
                    raise AssertionError(f"adaptive pair {i} launched kernel "
                                         f"E {n_e} times in {got['i_fin']} "
                                         f"layers")
                if not same and not margin < 1e-5:
                    raise AssertionError(f"adaptive pair {i} ({mode}) parted "
                                         f"from its plain twin at a margin "
                                         f"of {margin:.3g}")
                rows.append({"i_fin": got["i_fin"], "keep": got["keep"],
                             "margin": margin, "launches": n_e,
                             "syncs": got["syncs"], "plain_equal": same})
            out[mode] = {"pairs": rows, "e_err_over_v_scale": e_err,
                         "i_fin_median": statistics.median(
                             r["i_fin"] for r in rows),
                         "min_margin": min(r["margin"] for r in rows)}
        shrunk = [r for r in out["pruning"]["pairs"]
                  if len(set(r["keep"])) > 2]
        if not shrunk:
            raise AssertionError("the pruning mode shrank no pair's masks "
                                 "layer by layer")

        syncs = host_syncs(lambda: lightglue_forward_adaptive(lg, *pairs[0]))
        out["host_syncs_per_pair"] = len(syncs)
        log(f"  synchronizing operations in one default pair: {len(syncs)} "
            f"{sorted(set(syncs))[:2]}")
        ad, fx = timed_in_turns(
            lambda: [lightglue_forward_adaptive(lg, *a) for a in pairs],
            lambda: [lightglue_forward(lg, *a) for a in pairs])
        out["ms_adaptive_pair"] = statistics.median(ad) * 1e3 / ADAPT_PAIRS
        out["ms_fixed_depth_pair"] = statistics.median(fx) * 1e3 / ADAPT_PAIRS
        log(f"  a pair in turns, host clock: adaptive "
            f"{out['ms_adaptive_pair']:.4f} ms, fixed depth (9 layers) "
            f"{out['ms_fixed_depth_pair']:.4f} ms on {card}")

        def sdpa_calls(calls):
            masks = [torch.where(a[3], 0.0, -1e9)[..., None, :]
                     for a, _ in calls]
            return lambda: [F.scaled_dot_product_attention(
                a[0], a[1], a[2], attn_mask=m, scale=a[4])
                for (a, _), m in zip(calls, masks)]

        for mode, calls in own_calls.items():
            n = len(calls)
            e_ms, lib_ms, turns = in_turns(
                lambda: [cuda_attention.attention_cuda(*a, **kw)
                         for a, kw in calls], sdpa_calls(calls))
            plain_ms = cuda_ms(lambda: [fused_attention(*a, **kw)
                                        for a, kw in calls], iters=3)
            bound, by = adaptive_attention_bound(calls)
            out[mode].update(e_ms_call=e_ms / n, sdpa_ms_call=lib_ms / n,
                             plain_ms_call=plain_ms / n,
                             bound_ms_call=bound / n, bound_by=by, calls=n)
            log(f"  kernel E on pair 0's {n} calls ({mode}, "
                f"{tuple(calls[0][0][0].shape)}): {e_ms / n:.4f} ms a call, "
                f"sdpa {lib_ms / n:.4f}, plain {plain_ms / n:.4f}, bound "
                f"{bound / n:.4f} ({by}); in turns kernel, sdpa, sdpa, "
                f"kernel {[round(t / n, 4) for t in turns]} on {card}")

    with phase("kernel E on an emptied side"):
        emptied = [(a, kw) for a, kw in own_calls["pruning"]
                   if bool((~a[3].flatten(0, -2).any(-1)).any())]
        for mode in modes:
            for a, kw in own_calls[mode]:
                got = cuda_attention.attention_cuda(*a, **kw)
                dead = ~a[3].any(-1)               # [2, 4]: slices with no key
                if bool(dead.any()):
                    uni = a[2].mean(-2, keepdim=True).expand_as(got)
                    if not torch.allclose(got[dead], uni[dead], atol=1e-5,
                                          rtol=1e-5):
                        raise AssertionError("an emptied side's rows are not "
                                             "uniform")
        gen = torch.Generator(device=dev).manual_seed(41)
        q, k, v = (torch.randn((2, 4, K, 64), device=dev, generator=gen)
                   for _ in range(3))
        kv = torch.stack([torch.zeros(K, dtype=torch.bool, device=dev),
                          torch.rand(K, device=dev, generator=gen) > 0.5])
        got = cuda_attention.masked_attention(
            q, k, v, cuda_attention.head_mask(kv, 4))
        want = fused_attention(q, k, v, kv[:, None])
        err = float((got - want).abs().max())
        errs["attention"] = max(errs["attention"], err)
        uniform = torch.allclose(got[0], v[0].mean(-2, keepdim=True)
                                 .expand_as(got[0]), atol=1e-5, rtol=1e-5)
        out["emptied_calls"] = len(emptied)
        log(f"  the pruning run's calls with an emptied side: "
            f"{len(emptied)}; [2,4,{K},64] with side 0 emptied: max abs err "
            f"{err:.3g}, rows of the empty side uniform {uniform}")
        if not (err <= 1e-5 and uniform):
            raise AssertionError("kernel E differs on an emptied side")

    with phase("MHA runner: SuperPoint + adaptive light_glue, 4 pairs at "
               f"{SIZE}^2"):
        cfg = EvalConfig(
            model_type="SuperPoint", task_type="MHA",
            data_params={"type": "synthetic_homography", "num_pairs": 4,
                         "image_size": SIZE},
            extractor_params={"nms_dist": 6, "border_dist": 8, "top_k": K,
                              "threshold": 0, "min_score": 0.0},
            matcher_params={"type": "light_glue",
                            "light_glue_params": {"adaptive": True}},
            task_params={"th": [3, 5, 7]}, weights_dir=ctx["weights_dir"],
            output_dir=os.path.join(ROOT, "output", "chip_smoke_mha_adaptive"))
        reset_launches()
        res = Evaluator(cfg, DEVICE).run()
        got = read_launches()
        with plain_twins():
            res_p = Evaluator(cfg, DEVICE).run()
        out["runner"] = {f"MHA@{t}": res[f"MHA@{t}"] for t in (3, 5, 7)}
        out["runner_launches"] = got["attention"]
        log(f"  MHA@3/5/7 {[res[f'MHA@{t}'] for t in (3, 5, 7)]} (plain "
            f"{[res_p[f'MHA@{t}'] for t in (3, 5, 7)]}); launches {got}")
        if got["attention"] <= 0 or got["attention"] > 4 * 18:
            raise AssertionError(f"the adaptive runner's kernel E launches: "
                                 f"{got}")
        if res["per_pair"] != res_p["per_pair"]:
            raise AssertionError("the adaptive MHA runner differs from the "
                                 "plain twins")
    return out


def five_point_phases(dev, card, auc):
    """The five-point solver (phase 43) on phase 17's ground-truth
    correspondences, card against the CPU, and the AUC runner with solver
    5pt against its plain twin; timed in turns with the 8-point path."""
    from dataclasses import replace

    import numpy as np
    import torch

    from keypoint_bench_tpu_torch.geometry import fivepoint, ransac
    from keypoint_bench_tpu_torch.runner import Evaluator
    from keypoint_bench_tpu_torch.tasks.auc import (estimate_pose_pair,
                                                    pose_error)

    out = {}
    g0, g1, vw, Ks, poses = auc["ground_truth"]
    p0n = (g0 - Ks[:, None, :2, 2]) / Ks[:, None, [0, 1], [0, 1]]
    p1n = (g1 - Ks[:, None, :2, 2]) / Ks[:, None, [0, 1], [0, 1]]
    th = 4.0 / (2 * Ks[:, 0, 0] + 2 * Ks[:, 1, 1])   # 1 px / f_mean
    n_samples = max(AUC_NHYP // 8, 64)
    with phase(f"five-point solver: card vs CPU on ground truth, "
               f"{AUC_PAIRS} SE3 pairs"):
        def best_errors(p0, p1, mask, idx, pose):
            """The smallest pose error (float64) of each sample's valid
            candidates, recoverPose on all the pair's correspondences."""
            es, valid = fivepoint.five_point_candidates(
                ransac._take(p0, idx), ransac._take(p1, idx))
            R, t, _, _ = ransac.recover_pose(
                es, p0[:, None, None], p1[:, None, None],
                mask[:, None, None])
            err = pose_error(R.double(), t.double(),
                             pose.double()[:, None, None])
            return torch.where(valid, err, torch.inf).amin(-1)

        # a sample "recovers" the pose when one of its valid candidates is
        # within 1 degree of the truth (the correspondences are exact up
        # to float32). One float32 minimal solve is rounding-sensitive: it
        # can lose a root (tests/test_fivepoint.py asks 75% of samples),
        # and its best pose moves with the nullspace basis and the
        # determinant signs, which the card's and the CPU's solvers round
        # apart. The CPU against itself on inputs moved by 1e-7 relative
        # is printed beside it as the yardstick. Gates: both recovery
        # rates over 75% and within 2% of each other, and on the samples
        # both recover the median card-CPU gap within phase 17's 0.1
        # degree (the consensus RANSAC below is held sample for sample)
        fixed = ransac._sample_minimal(
            vw, 64, 5, torch.Generator(device=dev).manual_seed(43))
        e_c = best_errors(p0n, p1n, vw, fixed, poses).cpu()
        cpu = [a.cpu() for a in (p0n, p1n, vw, fixed, poses)]
        e_h = best_errors(*cpu)
        e_m = best_errors(cpu[0] * (1 + 1e-7), *cpu[1:])
        n = e_c.numel()

        def spread(a, b):
            ra, rb = a < 1.0, b < 1.0
            d = (a - b)[ra & rb].abs()
            return {"recovered": [int(ra.sum()), int(rb.sum())],
                    "both": int((ra & rb).sum()),
                    "median_gap_deg": float(d.median()),
                    "q90_gap_deg": float(d.quantile(0.9)),
                    "max_gap_deg": float(d.max())}

        out["candidates"] = {"samples": n, "card_vs_cpu": spread(e_c, e_h),
                             "cpu_vs_cpu_moved_1e-7": spread(e_h, e_m)}
        cc = out["candidates"]["card_vs_cpu"]
        log(f"  64 fixed samples a pair ({n}): the pose recovered (a valid "
            f"candidate within 1 degree) card / CPU {cc['recovered']}, both "
            f"{cc['both']}; median best pose error card "
            f"{float(e_c.median()):.4g} degrees, CPU "
            f"{float(e_h.median()):.4g}; card-CPU gap on the samples both "
            f"recover {cc}; the CPU against itself on inputs moved by 1e-7: "
            f"{out['candidates']['cpu_vs_cpu_moved_1e-7']}")
        rec = cc["recovered"]
        if not (cc["median_gap_deg"] <= 0.1 and min(rec) >= 0.75 * n
                and abs(rec[0] - rec[1]) <= 0.02 * n):
            raise AssertionError("five-point candidates differ between the "
                                 "card and the CPU")

        samples = ransac._sample_minimal(
            vw, n_samples, 5, torch.Generator(device=dev).manual_seed(1))
        E, inl, ok = fivepoint.ransac_essential_5pt_from_samples(
            p0n, p1n, vw, samples, th)
        Eh, inl_h, ok_h = fivepoint.ransac_essential_5pt_from_samples(
            *(a.cpu() for a in (p0n, p1n, vw, samples, th)))
        res = ransac._sampson(E, p0n, p1n).cpu()
        res_h = ransac._sampson(Eh, p0n.cpu(), p1n.cpu())
        parted = inl.cpu() != inl_h
        near = ((res - th.cpu()[:, None]).abs() <= 1e-6) | (
            (res_h - th.cpu()[:, None]).abs() <= 1e-6)
        out["ransac_parted_inliers"] = int(parted.sum())
        log(f"  RANSAC over {n_samples} samples a pair: inliers card "
            f"{inl.sum(-1).tolist()}, CPU {inl_h.sum(-1).tolist()}; parted "
            f"{int(parted.sum())}, of them within 1e-6 of the threshold "
            f"{int((parted & near).sum())}")
        if not (torch.equal(ok.cpu(), ok_h) and bool(ok_h.all())
                and not bool((parted & ~near).any())):
            raise AssertionError("five-point RANSAC differs between the "
                                 "card and the CPU")

        gen = torch.Generator(device=dev).manual_seed(0)
        args = (g0, g1, vw, Ks, Ks)
        five, eight = timed_in_turns(
            lambda: estimate_pose_pair(*args, gen, n_hyp=AUC_NHYP,
                                       solver="5pt"),
            lambda: estimate_pose_pair(*args, gen, n_hyp=AUC_NHYP))
        out["ms_pair_5pt"] = statistics.median(five) * 1e3 / AUC_PAIRS
        out["ms_pair_8pt"] = statistics.median(eight) * 1e3 / AUC_PAIRS
        out["candidates_ms"] = cuda_ms(
            lambda: fivepoint.five_point_candidates(
                ransac._take(p0n, samples), ransac._take(p1n, samples)),
            iters=3)
        syncs = host_syncs(lambda: estimate_pose_pair(
            *args, gen, n_hyp=AUC_NHYP, solver="5pt"))
        out["host_syncs"] = len(syncs)
        log(f"  estimate_pose_pair a pair in turns ({AUC_PAIRS} pairs a "
            f"call, n_hyp {AUC_NHYP}): 5pt {out['ms_pair_5pt']:.4f} ms "
            f"({n_samples} samples), 8pt {out['ms_pair_8pt']:.4f} ms; the "
            f"5pt candidates of {AUC_PAIRS} x {n_samples} samples "
            f"{out['candidates_ms']:.4f} ms; host syncs {len(syncs)} on "
            f"{card}")

    with phase("AUC runner: ALIKE-t + brute force, solver 5pt, 4 SE3 pairs "
               f"at {SIZE}^2"):
        cfg = replace(auc["runner_cfg"],
                      task_params={"th": [5, 10, 20], "solver": "5pt"},
                      output_dir=os.path.join(ROOT, "output",
                                              "chip_smoke_auc_5pt"))
        reset_launches()
        res = Evaluator(cfg, DEVICE).run()
        got = read_launches()
        with plain_twins():
            res_p = Evaluator(cfg, DEVICE).run()
        e, e_p = (np.asarray(r["per_pair_error"]) for r in (res, res_p))
        out["runner"] = {**{f"AUC@{t}": res[f"AUC@{t}"] for t in (5, 10, 20)},
                         "AUC_inliers": res["AUC_inliers"],
                         "per_pair_error": e.tolist()}
        log(f"  per-pair error {e.tolist()} (plain {e_p.tolist()}); AUC@5/"
            f"10/20 {[res[f'AUC@{t}'] for t in (5, 10, 20)]} (8pt "
            f"{auc['runner']['AUC@20']} at 20); inliers "
            f"{res['AUC_inliers']} (plain {res_p['AUC_inliers']}, 8pt "
            f"{auc['runner']['AUC_inliers']}); launches {got}")
        if got["nms"] <= 0 or got["nn_match"] <= 0:
            raise AssertionError(f"the 5pt AUC runner missed kernel A or D: "
                                 f"{got}")
        if not (np.median(e) < 10.0 and res["AUC@20"] > 0.3
                and np.abs(e - e_p).max() <= 1e-3
                and res["AUC_inliers"] == res_p["AUC_inliers"]):
            raise AssertionError("the 5pt AUC runner missed its gates or "
                                 "differs from the plain twins")
    return out


def tracking_error_phases(dev, card, errs):
    """VisualizeTrackingError (phase 44) through the runner: ALIKE-t and
    LETNet on TRACK_PAIRS homography pairs, kernels A and F (F starting
    from the warped points), against the plain twin at LK distance 0 and
    at the shipped distance."""
    import numpy as np
    import torch

    from keypoint_bench_tpu_torch.ops import cuda_lk
    from keypoint_bench_tpu_torch.ops.lk import _lk_level
    from keypoint_bench_tpu_torch.runner import EvalConfig, Evaluator

    out = {}
    with phase(f"VisualizeTrackingError: ALIKE-t and LETNet, {TRACK_PAIRS} "
               f"pairs at {SIZE}^2"):
        for model in ("Alike", "LETNet"):
            for dist in (0, TRACK_LK["distance"]):
                cfg = EvalConfig(
                    model_type=model, task_type="VisualizeTrackingError",
                    data_params={"type": "synthetic_homography",
                                 "num_pairs": TRACK_PAIRS,
                                 "image_size": SIZE},
                    extractor_params={"nms_dist": 6, "border_dist": 8,
                                      "top_k": K, "threshold": 0,
                                      "min_score": 0.0},
                    matcher_params={"type": "optical_flow",
                                    "optical_flow_params": {
                                        **TRACK_LK, "distance": dist}},
                    output_dir=os.path.join(ROOT, "output",
                                            "chip_smoke_track"))
                reset_launches()
                with recording(cuda_lk, "lk_level_cuda") as calls:
                    res = Evaluator(cfg, DEVICE).run()
                got = read_launches()
                with plain_twins():
                    res_p = Evaluator(cfg, DEVICE).run()
                far, n_pts, lk_err = 0, 0, 0.0
                for a, kw in calls:
                    e = (cuda_lk.lk_level_cuda(*a, **kw)
                         - _lk_level(*a, **kw)).abs().amax(-1)
                    lk_err = max(lk_err, float(e.max()))
                    far += int((e > 1e-2).sum())
                    n_pts += e.numel()
                errs["lk"] = max(errs["lk"], lk_err)
                e, e_p = (np.asarray(r["per_pair"]) for r in (res, res_p))
                t0 = time.perf_counter()
                Evaluator(cfg, DEVICE).run()
                ms = (time.perf_counter() - t0) * 1e3 / TRACK_PAIRS
                out[f"{model} distance {dist}"] = r = {
                    "track_error": res["track_error"],
                    "plain": res_p["track_error"], "per_pair": e.tolist(),
                    "launches": {k: got[k] for k in ("nms", "lk")},
                    "ms_pair": ms, "lk_max_abs_err": lk_err,
                    "lk_beyond_1e-2": far}
                log(f"  {model}, LK distance {dist}: track_error "
                    f"{res['track_error']} (plain {res_p['track_error']}); "
                    f"per pair {e.tolist()}; launches {r['launches']}; F on "
                    f"its {len(calls)} calls max abs err {lk_err:.3g}, "
                    f"{far} of {n_pts} beyond 1e-2 px; {ms:.2f} ms a pair "
                    f"(the runner's host clock, rendering included) on "
                    f"{card}")
                if got["nms"] != 2 * TRACK_PAIRS or \
                        got["lk"] != TRACK_LK["levels"] * TRACK_PAIRS:
                    raise AssertionError(f"the tracking-error runner's "
                                         f"launches: {got}")
                if far > 0.01 * n_pts:
                    raise AssertionError(f"kernel F differs on the tracking-"
                                         f"error runner's calls: {far} of "
                                         f"{n_pts} beyond 1e-2 px")
                tol = (1e-3 * np.abs(e_p) + 1e-5) if dist == 0 else 1e-3
                if not (np.isfinite(e).all() and (e > 0).all()
                        and (np.abs(e - e_p) <= tol).all()):
                    raise AssertionError(f"the tracking error differs from "
                                         f"the plain twin ({model}, distance "
                                         f"{dist})")
    return out


# Loop closure, the pose graph, predict_positions and save_images (phases
# 45-49): tests/test_loop_closure.py's sequences at full width
LOOP_MID = 15          # phase 46: 31 frames out and back (378 pairs at gap 4)
LOOP_SCALED_MID = 4    # phase 47: 9 frames, the return 0.3 to the side
LOOP_GAP = 4
LOOP_NHYP = 1024       # detect_loop_closures_scaled's default
PGO_ITERS = 15         # optimize_with_closures' default
SAVE_PAIRS = 2


def loop_poses(n_mid, return_offset=0.0):
    """Cam-from-world poses of tests/test_loop_closure.py's out-and-back
    path: 0.4 a frame along x out, then back on a line `return_offset` to
    the side."""
    import numpy as np
    xs = ([(0.4 * k, 0.0) for k in range(n_mid + 1)]
          + [(0.4 * k, return_offset) for k in range(n_mid - 1, -1, -1)])
    poses = []
    for x, y in xs:
        T = np.eye(4)
        T[0, 3], T[1, 3] = x, y
        poses.append(T)
    return poses


def loop_frames(n_mid, size, seed=0, return_offset=0.0, tex_scale=0.15):
    """tests/test_loop_closure.py's `_loop_frames` at size^2: the splat
    scene (900 blobs at depths 4-20 over the textured planes) along
    `loop_poses`. Returns (frames [T,size,size,3] float32, poses, K)."""
    import numpy as np
    from keypoint_bench_tpu_torch.datasets.synthetic import (_SplatScene,
                                                             _texture)
    scene = _SplatScene(size)
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.uniform(-4, 4, (900, 2)),
                        rng.uniform(4.0, 20.0, (900, 1))], axis=1)
    colors = rng.uniform(0.3, 1.0, (900, 3)).astype(np.float32)
    tex = _texture(size, size, rng) * tex_scale
    poses = loop_poses(n_mid, return_offset)
    frames = [scene._render(X, colors, T[:3, :3], T[:3, 3], tex)[0]
              for T in poses]
    return np.stack(frames).astype(np.float32), poses, scene.K


def geometric_loop(n_pts=200, t_frames=6, seed=0,
                   closure_offset=(0.05, 0.3, 0.0)):
    """tests/test_loop_closure.py's `_geometric_loop_fixture`: exact
    projections of 200 points with unique unit descriptors; frames 0-4
    march along x, the last revisits frame 0 displaced by
    `closure_offset`. Returns (kpts_px [T][N,2], descs [T,N,32], poses,
    K)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    K = np.array([[230.0, 0, 128], [0, 230.0, 128], [0, 0, 1]], np.float32)
    X = np.concatenate([rng.uniform(-2.5, 2.5, (n_pts, 2)),
                        rng.uniform(3.0, 8.0, (n_pts, 1))], axis=1)
    descrs = rng.normal(0, 1, (n_pts, 32)).astype(np.float32)
    descrs /= np.linalg.norm(descrs, axis=1, keepdims=True)
    poses = []
    for k in range(t_frames - 1):
        T = np.eye(4)
        T[0, 3] = 0.4 * k
        poses.append(T)
    T = np.eye(4)
    T[:3, 3] = np.asarray(closure_offset)
    poses.append(T)
    kpts = []
    for T in poses:
        Xc = X @ T[:3, :3].T + T[:3, 3]
        uv = (Xc / Xc[:, 2:3]) @ K.T
        kpts.append(uv[:, :2].astype(np.float64))
    return kpts, np.stack([descrs] * t_frames), poses, K


def exact_odometry(poses):
    """(R_rel, t_rel unit, scales) of consecutive cam-from-world poses."""
    import numpy as np
    R_rel, t_rel, scales = [np.eye(3)], [np.zeros(3)], [0.0]
    for i in range(1, len(poses)):
        T = poses[i] @ np.linalg.inv(poses[i - 1])
        s = np.linalg.norm(T[:3, 3])
        scales.append(s)
        R_rel.append(T[:3, :3])
        t_rel.append(T[:3, 3] / max(s, 1e-9))
    return np.stack(R_rel), np.stack(t_rel), scales


def noisy_odometry(poses, seed=3, rot_noise=0.03, dir_noise=0.1):
    """tests/test_loop_closure.py's `_noisy_odometry` (the rotation noise
    through the port's Rodrigues, equal to cv2's within 1e-12)."""
    import numpy as np
    from keypoint_bench_tpu_torch.datasets.synthetic import rodrigues
    rng = np.random.default_rng(seed)
    R_rel, t_rel, scales = [np.eye(3)], [np.zeros(3)], [0.0]
    for i in range(1, len(poses)):
        T = poses[i] @ np.linalg.inv(poses[i - 1])
        dR = rodrigues(rng.normal(0, rot_noise, 3))
        tt = T[:3, 3]
        s = np.linalg.norm(tt)
        scales.append(s)
        t_noisy = tt / max(s, 1e-9) + rng.normal(0, dir_noise, 3)
        R_rel.append(dR @ T[:3, :3])
        t_rel.append(t_noisy / np.linalg.norm(t_noisy))
    return np.stack(R_rel), np.stack(t_rel), scales


def loop_ate(Rf, tf, poses):
    """Mean camera-centre error of world->camera (Rf, tf) against the
    cam-from-world ground truth."""
    import numpy as np
    gt = np.stack([-T[:3, :3].T @ T[:3, 3] for T in poses])
    c = np.stack([-Rf[i].T @ tf[i] for i in range(len(poses))])
    return float(np.linalg.norm(c - gt, axis=1).mean())


def rot_deg(Ra, Rb):
    import numpy as np
    c = np.clip((np.trace(np.asarray(Ra).T @ np.asarray(Rb)) - 1) / 2, -1, 1)
    return float(np.degrees(np.arccos(c)))


def closures_gap(got, ref):
    """(same (i, j, n) in the same order, max |R - R'|, max |t - t'|)."""
    import numpy as np
    same = [(c[0], c[1], c[-1]) for c in got] == \
        [(c[0], c[1], c[-1]) for c in ref]
    dr = max([float(np.abs(np.asarray(a[2]) - np.asarray(b[2])).max())
              for a, b in zip(got, ref)] or [0.0])
    dt = max([float(np.abs(np.asarray(a[3]) - np.asarray(b[3])).max())
              for a, b in zip(got, ref) if len(a) == 5] or [0.0])
    return same, dr, dt


def ransac_e_witness(p0n, p1n, mask, idx, thresh, dev):
    """RANSAC-E of one candidate from the same inputs and minimal samples
    (p0n, p1n [K, 2] float32 normalized coordinates, mask [K], idx [n_hyp,
    8]) in float32 and float64, on the card and on the CPU. Per route: the
    best hypothesis (index, inlier count), the inliers after the refits;
    under the float64 CPU solve, that hypothesis's inlier count and the
    inliers of the refits from it. The card's float32 route is the port's
    as it runs (its 8-point solves in float64: `_solve_minimal_e`,
    `_solve_eightpoint_e`)."""
    import torch

    from keypoint_bench_tpu_torch.geometry.ransac import (
        _essential_project, _sampson, _solve_eightpoint_e, _solve_minimal_e,
        _take, ransac_essential_from_samples)

    def hypothesis_inliers(a, b, m, ix):
        e9, valid = _solve_minimal_e(_take(a, ix), _take(b, ix))
        res = _sampson(_essential_project(e9), a[None], b[None])
        return (res < thresh) & m & valid[:, None]

    def refits_from(inl):
        """The float64 CPU refits from one hypothesis's inliers."""
        a, b = p0n.double(), p1n.double()
        w = inl.double()
        for _ in range(3):
            e = _essential_project(_solve_eightpoint_e(a, b, w))
            w = ((_sampson(e, a, b) < thresh) & mask).double()
        return int(w.sum())

    out, ref = {}, None
    for side, where in (("cpu", torch.device("cpu")), ("card", dev)):
        for dt in (torch.float64, torch.float32):
            a, b = p0n.to(where, dt), p1n.to(where, dt)
            m, ix = mask.to(where), idx.to(where)
            hyp = hypothesis_inliers(a, b, m, ix).cpu()
            _, inl, _ = ransac_essential_from_samples(a, b, m, ix, thresh)
            if ref is None:
                ref = hyp
            c = hyp.sum(-1)
            best = int(c.argmax())
            out[f"{side}_{str(dt)[6:]}"] = {
                "best": best, "best_count": int(c[best]),
                "inliers": int(inl.sum()),
                "best_count_f64": int(ref[best].sum()),
                "inliers_f64_from_best": refits_from(ref[best])}
    return out


def loop_closure_phases(dev, card, errs):
    """Loop closure and the pose graph (phases 45-48): the pose graph on
    the card against its CPU twin; strong closures over every frame pair
    of a 31-frame splat loop (kernel D once over all pairs, against the
    per-pair loop and the CPU twin) and the pose-graph correction; scaled
    closures on the geometric fixture and, with LK neighbour tracks
    (kernel F), on a parallax loop against the CPU twin under the same
    draws; predict_positions on SuperPoint's coarse maps against the CPU
    twin. Returns the numbers for the JSON lines."""
    import numpy as np
    import torch

    from keypoint_bench_tpu_torch.ba.pose_graph import pgo_solve
    from keypoint_bench_tpu_torch.geometry.ransac import _sample_minimal
    from keypoint_bench_tpu_torch.models import get_model
    from keypoint_bench_tpu_torch.ops import cuda_lk, cuda_match
    from keypoint_bench_tpu_torch.ops.detect import DetectParams
    from keypoint_bench_tpu_torch.ops.lk import _lk_level, draw_angles
    from keypoint_bench_tpu_torch.ops.matching import (mutual_nn_match,
                                                       nn_dists, penalized)
    from keypoint_bench_tpu_torch.ops.predict import predict_positions
    from keypoint_bench_tpu_torch.pipeline import detect_frames
    from keypoint_bench_tpu_torch.tasks.loop_closure import (
        closure_graph, closure_pairs, detect_loop_closures,
        detect_loop_closures_scaled, match_frame_pairs,
        optimize_with_closures)
    from keypoint_bench_tpu_torch.weights import (load_golden_params,
                                                  load_params)

    cpu = torch.device("cpu")
    out = {}
    model = get_model("Alike")(load_params("Alike", device=dev)).eval()
    dp = DetectParams(nms_dist=6, border_dist=8, top_k=K)

    def detect(frames):
        """ALIKE-t keypoints in pixels (host), sparse descriptors and
        masks (device) of frames [T,S,S,3] (kernels A and B)."""
        _, descs, kpts, valids = detect_frames(model, frames, dp, dev,
                                               sparse=True)
        kpx = (kpts[..., :2] * (frames.shape[1] - 1.0)).cpu().numpy()
        return list(kpx.astype(np.float64)), descs, valids

    n_poses = 2 * LOOP_MID + 1
    with phase(f"pose graph: {n_poses} poses out and back, "
               f"{PGO_ITERS} iterations, card vs CPU"):
        poses = loop_poses(LOOP_MID, return_offset=0.3)
        closures = []   # frame i and its revisit j, exact, at gap >= 4
        for i, j in [(i, n_poses - 1 - i) for i in range(LOOP_MID)]:
            if j - i >= LOOP_GAP:
                T = poses[j] @ np.linalg.inv(poses[i])
                closures.append((i, j, T[:3, :3], T[:3, 3], 0))
        gt = np.stack([-T[:3, :3].T @ T[:3, 3] for T in poses])
        extent = float(np.ptp(gt, axis=0).max())
        res = {}
        for name, odo in (("noisy", noisy_odometry(poses)),
                          ("exact", exact_odometry(poses))):
            g = closure_graph(*odo, closures, device=dev)
            R, t, r = pgo_solve(g, PGO_ITERS, 1e-4)
            t0 = time.perf_counter()
            Rc, tc, rc = pgo_solve(closure_graph(*odo, closures,
                                                 device="cpu"),
                                   PGO_ITERS, 1e-4)
            cpu_ms = (time.perf_counter() - t0) * 1e3
            gap = max(float((R.cpu() - Rc).abs().max()),
                      float((t.cpu() - tc).abs().max()))
            R0, t0_, _ = pgo_solve(g, 0)
            res[name] = {
                "residual": float(r), "residual_cpu": float(rc),
                "gap_card_cpu": gap,
                "ate_before": loop_ate(R0.cpu().numpy(), t0_.cpu().numpy(),
                                       poses),
                "ate_after": loop_ate(R.cpu().numpy(), t.cpu().numpy(),
                                      poses),
                "ms": cuda_ms(lambda: pgo_solve(g, PGO_ITERS, 1e-4),
                              iters=5, warmup=1),
                "cpu_ms": cpu_ms,
                "host_syncs": host_syncs(
                    lambda: pgo_solve(g, PGO_ITERS, 1e-4))}
            log(f"  {name} odometry + {len(closures)} exact closures: "
                f"residual {res[name]['residual']:.3g} (CPU "
                f"{res[name]['residual_cpu']:.3g}); card vs CPU "
                f"{gap:.3g} (extent {extent:.2f}); ATE "
                f"{res[name]['ate_before']:.4f} -> "
                f"{res[name]['ate_after']:.4f}; pgo_solve "
                f"{res[name]['ms']:.3f} ms on the card "
                f"({res[name]['cpu_ms']:.1f} ms on the CPU); host syncs "
                f"{len(res[name]['host_syncs'])} {res[name]['host_syncs']} "
                f"on {card}")
            if gap > 1e-4 * extent:
                raise AssertionError(f"pgo_solve card vs CPU {gap}")
            if res[name]["host_syncs"]:
                raise AssertionError("pgo_solve synchronizes with the host")
        if res["exact"]["residual"] >= 1e-5:
            raise AssertionError(f"exact measurements leave residual "
                                 f"{res['exact']['residual']}")
        if not res["noisy"]["ate_after"] < res["noisy"]["ate_before"]:
            raise AssertionError(f"the closures do not pull the chain "
                                 f"shut: {res['noisy']}")
        out["pose_graph"] = res

    with phase(f"strong closures: {n_poses} splat frames at {SIZE}^2, "
               f"every pair at gap >= {LOOP_GAP} in one kernel D launch"):
        t0 = time.perf_counter()
        frames, poses, Kc = loop_frames(LOOP_MID, SIZE)
        render_s = time.perf_counter() - t0
        pairs = closure_pairs(len(frames), LOOP_GAP)
        odo = noisy_odometry(poses)
        reset_launches()
        t0 = time.perf_counter()
        kpx, descs, valids = detect(frames)
        cl = detect_loop_closures(descs, valids, kpx, Kc, min_gap=LOOP_GAP,
                                  min_matches=80)
        Rb, tb, _ = optimize_with_closures(*odo, [], iters=0, device=dev)
        Ra, ta, _ = optimize_with_closures(*odo, cl, iters=PGO_ITERS,
                                           device=dev)
        path_ms = (time.perf_counter() - t0) * 1e3
        got = read_launches()
        a0, a1 = loop_ate(Rb, tb, poses), loop_ate(Ra, ta, poses)
        # the batched call against the per-pair loop on the card
        nn_b, ok_b = match_frame_pairs(descs, valids, pairs)
        differ = 0
        for p, (i, j) in enumerate(pairs):
            nn_p, ok_p = mutual_nn_match(descs[i], descs[j], valids[i],
                                         valids[j], 5.0)
            ok_p = ok_p.cpu().numpy()
            differ += int((ok_p != ok_b[p]).sum()
                          + (nn_p.cpu().numpy()[ok_p] != nn_b[p][ok_p]).sum())
        cl_cpu = detect_loop_closures(descs.cpu(), valids.cpu(), kpx, Kc,
                                      min_gap=LOOP_GAP, min_matches=80)
        same, dr, _ = closures_gap(cl, cl_cpu)

        def per_pair():
            for i, j in pairs:
                nn_p, ok_p = mutual_nn_match(descs[i], descs[j], valids[i],
                                             valids[j], 5.0)
                ok_p.cpu(), nn_p.cpu()

        batched_ms = host_ms(lambda: detect_loop_closures(
            descs, valids, kpx, Kc, min_gap=LOOP_GAP, min_matches=80), 3)
        loop_ms = host_ms(per_pair, 3)
        syncs = host_syncs(lambda: detect_loop_closures(
            descs, valids, kpx, Kc, min_gap=LOOP_GAP, min_matches=80))
        # kernel D at the batched call's shapes
        ii = torch.tensor([p[0] for p in pairs], device=dev)
        jj = torch.tensor([p[1] for p in pairs], device=dev)
        a, _ = penalized(descs[ii], valids[ii])
        b, _ = penalized(descs[jj], valids[jj])
        near, err_free, _ = check_nn(cuda_match.nn_dists_cuda(a, b),
                                     nn_dists(a, b), a, b)
        errs["nn_match"] = max(errs["nn_match"], err_free)
        d_ms = cuda_ms(lambda: cuda_match.nn_dists_cuda(a, b))
        d_plain_ms = cuda_ms(lambda: nn_dists(a, b), iters=3, warmup=1)
        d_lib_ms = cuda_ms(mm_min(a, b), iters=3, warmup=1)
        d_bound, d_by = match_bound(a, b)
        out["strong"] = r = {
            "frames": len(frames), "pairs": len(pairs),
            "closures": [(c[0], c[1], c[3]) for c in cl],
            "closures_equal_cpu": same, "R_gap_cpu": dr,
            "per_pair_differences": differ, "launches": got,
            "ate_before": a0, "ate_after": a1, "path_ms": path_ms,
            "render_s": render_s, "batched_ms": batched_ms,
            "per_pair_loop_ms": loop_ms, "host_syncs": len(syncs),
            "kernel_d": {"shape": list(a.shape), "ms": d_ms,
                         "plain_ms": d_plain_ms, "library_ms": d_lib_ms,
                         "bound_ms": d_bound, "bound_by": d_by,
                         "near_ties": near, "max_abs_err": err_free}}
        log(f"  {len(cl)} closures of {len(pairs)} pairs "
            f"({r['closures'][:6]}...); equal to the CPU twin: {same} "
            f"(R gap {dr:.3g}); batched vs per-pair loop: {differ} "
            f"differences; ATE {a0:.4f} -> {a1:.4f}; launches {got}")
        log(f"  detect_loop_closures {batched_ms:.2f} ms (host clock, one "
            f"kernel D call, {len(syncs)} host syncs: {syncs}) against "
            f"{loop_ms:.2f} ms for the per-pair loop ({2 * len(pairs)} "
            f"launches); the path (detection, "
            f"closures, pose graph) {path_ms:.1f} ms; rendering "
            f"{render_s:.1f} s on the host")
        log(f"  kernel D at {list(a.shape)}: {d_ms:.4f} ms, plain "
            f"{d_plain_ms:.4f}, baddbmm + minima {d_lib_ms:.4f}, bound "
            f"{d_bound:.4f} ({d_by}); near ties {near}, max abs err "
            f"{err_free:.3g} on {card}")
        # one kernel D call: its two launches (cuda_match.nn_dists_cuda)
        if got["nn_match"] != 2 or got["nms"] < 1 or got["sample"] < 1:
            raise AssertionError(f"the loop-closure path's launches: {got}")
        if differ or not same or dr > 1e-6:
            raise AssertionError("the batched closures differ from the "
                                 "per-pair loop or the CPU twin")
        if not cl or not a1 < 0.8 * a0:
            raise AssertionError(f"no drift correction: ATE {a0} -> {a1}, "
                                 f"{len(cl)} closures")

    with phase("scaled closures: the geometric fixture on the card, and "
               f"a parallax loop at {SIZE}^2 with LK tracks (kernel F)"):
        kg, dg, pg, Kg = geometric_loop()
        gen = torch.Generator(device=dev).manual_seed(0)
        clg = detect_loop_closures_scaled(
            torch.as_tensor(dg, device=dev),
            torch.ones(dg.shape[:2], dtype=torch.bool, device=dev), kg, Kg,
            *exact_odometry(pg), gen, min_gap=LOOP_GAP, min_matches=60)
        scaled = {(c[0], c[1]): c for c in clg
                  if np.linalg.norm(c[3]) > 0.05}
        last = len(pg) - 1
        if (0, last) not in scaled:
            raise AssertionError(f"no metric closure (0, {last}): "
                                 f"{[(c[0], c[1]) for c in clg]}")
        T_gt = pg[last] @ np.linalg.inv(pg[0])
        dt = float(np.linalg.norm(scaled[(0, last)][3] - T_gt[:3, 3]))
        da = rot_deg(scaled[(0, last)][2], T_gt[:3, :3])
        log(f"  geometric fixture: closure (0, {last}) t off by {dt:.3g}, "
            f"R by {da:.3g} degrees")
        if dt >= 0.05 or da >= 2.0:
            raise AssertionError("the metric closure is off")
        frames, poses, Ks = loop_frames(LOOP_SCALED_MID, SIZE,
                                        return_offset=0.3, tex_scale=0.6)
        odo = noisy_odometry(poses, rot_noise=0.02, dir_noise=0.02)
        # the same draws on both sides: samples from a CPU generator on
        # the candidates' masks, and fixed LK jitter angles
        angles = draw_angles((len(frames), K),
                             torch.Generator().manual_seed(1), cpu)
        draws = []

        def samples(masks):
            draws.append(_sample_minimal(masks.cpu(), LOOP_NHYP, 8,
                                         torch.Generator().manual_seed(0)))
            return draws[-1]

        kw = dict(min_gap=LOOP_GAP, min_matches=60, images=frames,
                  draw_samples=samples, angles=angles)
        reset_launches()
        t0 = time.perf_counter()
        with recording(cuda_lk, "lk_level_cuda") as calls:
            kpx, descs, valids = detect(frames)
            cls = detect_loop_closures_scaled(descs, valids, kpx, Ks, *odo,
                                              None, **kw)
        path_ms = (time.perf_counter() - t0) * 1e3
        got = read_launches()
        syncs = host_syncs(lambda: detect_loop_closures_scaled(
            descs, valids, kpx, Ks, *odo, None, **kw))
        t0 = time.perf_counter()
        cls_cpu = detect_loop_closures_scaled(descs.cpu(), valids.cpu(), kpx,
                                              Ks, *odo, None, **kw)
        cpu_s = time.perf_counter() - t0
        same, dr, dtc = closures_gap(cls, cls_cpu)
        # every parallax candidate's RANSAC-E (the rows the samples were
        # drawn for: matches >= 60, median flow in (4, 60] px) by route
        spairs = closure_pairs(len(frames), LOOP_GAP)
        nn_s, ok_s = match_frame_pairs(descs.cpu(), valids.cpu(), spairs)
        cands = [p for p, (i, j) in enumerate(spairs) if ok_s[p].sum() >= 60
                 and 4.0 < np.median(np.linalg.norm(
                     kpx[j][nn_s[p][ok_s[p]]] - kpx[i][ok_s[p]], axis=1))
                 <= 60.0]
        if len(cands) != len(draws[0]):
            raise AssertionError(f"{len(cands)} candidates, RANSAC-E drew "
                                 f"for {len(draws[0])}")
        fxy = np.array([Ks[0, 0], Ks[1, 1]])
        witness, apart = {}, []
        for n, p in enumerate(cands):
            i, j = spairs[p]
            w = witness[f"{i}-{j}"] = ransac_e_witness(
                torch.as_tensor((kpx[i] - Ks[:2, 2]) / fxy,
                                dtype=torch.float32),
                torch.as_tensor((kpx[j][nn_s[p]] - Ks[:2, 2]) / fxy,
                                dtype=torch.float32),
                torch.as_tensor(ok_s[p]), draws[0][n],
                float(np.float32(2.0 / Ks[0, 0])), dev)
            # the card's pick scores as the float64 CPU solve's best up to
            # a near tie (two float64 solvers round apart, which can move a
            # point that sits at the threshold), and its refits end where
            # the float64 CPU refits from the same pick end; both within
            # 0.5% of the matches
            w["matches"] = int(ok_s[p].sum())
            port, tie = w["card_float32"], 0.005 * w["matches"]
            if port["best_count_f64"] < w["cpu_float64"]["best_count"] - tie \
                    or abs(port["inliers"]
                           - port["inliers_f64_from_best"]) > tie:
                apart.append(f"{i}-{j}")
        far, n_pts, lk_err = 0, 0, 0.0
        for args, kwargs in calls:
            e = (cuda_lk.lk_level_cuda(*args, **kwargs)
                 - _lk_level(*args, **kwargs)).abs().amax(-1)
            lk_err = max(lk_err, float(e.max()))
            far += int((e > 1e-2).sum())
            n_pts += e.numel()
        errs["lk"] = max(errs["lk"], lk_err)
        envelope = []
        for i, j, _, tv, _ in cls:
            T = poses[j] @ np.linalg.inv(poses[i])
            envelope.append((float(np.linalg.norm(tv - T[:3, 3])),
                             0.3 + 0.06 * (j - i) + 0.35))
        out["scaled"] = r = {
            "geometric_t_err": dt, "geometric_R_deg": da,
            "frames": len(frames),
            "closures": [(c[0], c[1], c[4], np.asarray(c[3]).tolist())
                         for c in cls],
            "closures_cpu": [(c[0], c[1], c[4]) for c in cls_cpu],
            "ransac_candidates": len(cands), "ransac_e_by_route": witness,
            "ransac_e_apart_from_float64": apart, "closures_equal_cpu": same,
            "R_gap_cpu": dr, "t_gap_cpu": dtc, "launches": got,
            "host_syncs": len(syncs),
            "lk_calls": len(calls), "lk_max_abs_err": lk_err,
            "lk_beyond_1e-2": far, "envelope": envelope,
            "path_ms": path_ms, "cpu_twin_s": cpu_s}
        log(f"  parallax loop: {len(cls)} closures {r['closures']} (CPU "
            f"twin {r['closures_cpu']}), equal {same} (R gap {dr:.3g}, "
            f"t gap {dtc:.3g}); RANSAC-E of its {len(cands)} parallax "
            f"candidates by route {witness}; apart from the float64 solve "
            f"{apart}; {len(syncs)} host syncs; F on its "
            f"{len(calls)} calls max abs err {lk_err:.3g}, {far} of {n_pts} "
            f"beyond 1e-2 px; launches {got}; drift envelope {envelope}; "
            f"path {path_ms:.1f} ms, CPU twin {cpu_s:.1f} s on {card}")
        if got["lk"] < 3 or not calls:
            raise AssertionError(f"kernel F did not track the scaled "
                                 f"path's neighbours: {got}")
        if far > 0.01 * n_pts:
            raise AssertionError("kernel F differs on the scaled path")
        if apart:
            raise AssertionError(f"RANSAC-E on the card parts from the "
                                 f"float64 solve on {apart}")
        if not same or dr > 1e-4 or dtc > 1e-3:
            raise AssertionError("the scaled closures differ from the CPU "
                                 "twin")
        if any(e >= lim for e, lim in envelope):
            raise AssertionError("a scaled closure leaves the drift "
                                 "envelope")

    with phase(f"predict_positions: SuperPoint's coarse maps of a "
               f"{SIZE}^2 pair (golden randomized weights), card vs CPU"):
        sp = get_model("SuperPoint")(load_golden_params("SuperPoint",
                                                        dev)).eval()
        with torch.inference_mode():
            _, d = sp(torch.as_tensor(frames[:2], device=dev))
        got = predict_positions(d[0], d[1])
        ref = predict_positions(d[0].cpu(), d[1].cpu())
        f64 = predict_positions(d[0].double(), d[1].double()).cpu()
        xy_gap = float((got[:, :2].cpu() - ref[:, :2]).abs().max())
        s_gap = float((got[:, 2].cpu() - ref[:, 2]).abs().max())
        s64 = [float((x[:, 2].double().cpu() - f64[:, 2]).abs().max())
               for x in (got, ref)]
        ms = cuda_ms(lambda: predict_positions(d[0], d[1]))
        t0 = time.perf_counter()
        predict_positions(d[0].cpu(), d[1].cpu())
        cpu_ms = (time.perf_counter() - t0) * 1e3
        out["predict"] = r = {
            "shape": list(d[0].shape), "xy_gap": xy_gap,
            "score_gap": s_gap, "score_gap_f64_card": s64[0],
            "score_gap_f64_cpu": s64[1], "ms": ms, "cpu_ms": cpu_ms}
        log(f"  [{', '.join(map(str, d[0].shape))}]: xy gap {xy_gap:.3g}, "
            f"score gap {s_gap:.3g} (each side to float64: card "
            f"{s64[0]:.3g}, CPU {s64[1]:.3g}); {ms:.3f} ms on {card}, "
            f"{cpu_ms:.1f} ms on the CPU")
        if xy_gap > 1e-5 or s_gap > 1e-4 or not torch.isfinite(got).all():
            raise AssertionError("predict_positions card vs CPU")
    return out


def save_images_phases(dev, card):
    """save_images and save_metric_plot (phase 49): the runner on
    SAVE_PAIRS synthetic pairs of repeatability, MHA, AUC and the per-pair
    FundamentalMatrix (ALIKE-t + brute force at SIZE^2) on the card and
    on the CPU: the JAX runner's file names, and pixel-equal PNGs wherever
    the drawn inputs (keypoints, matches) are equal."""
    from dataclasses import replace

    import numpy as np
    import torch

    from keypoint_bench_tpu_torch.runner import EvalConfig, Evaluator

    cv2_ok = importlib.util.find_spec("cv2") is not None
    plt_ok = importlib.util.find_spec("matplotlib") is not None
    tasks = {
        "repeatability": {"type": "synthetic_homography",
                          "num_pairs": SAVE_PAIRS, "image_size": SIZE},
        "MHA": {"type": "synthetic_homography", "num_pairs": SAVE_PAIRS,
                "image_size": SIZE},
        "AUC": {"type": "synthetic_se3", "num_pairs": SAVE_PAIRS,
                "image_size": SIZE},
        "FundamentalMatrix": {"type": "synthetic_sequence",
                              "num_frames": SAVE_PAIRS, "image_size": SIZE,
                              "seed": 0}}
    out = {"cv2": cv2_ok, "matplotlib": plt_ok}
    with phase(f"save_images: 4 tasks x {SAVE_PAIRS} pairs at {SIZE}^2, "
               f"card vs CPU"):
        if not cv2_ok:
            raise AssertionError("cv2 does not import: save_images cannot "
                                 "run")
        import cv2
        root = os.path.join(ROOT, "output", "chip_smoke_save_images")

        def host(x):
            return x.cpu().numpy() if isinstance(x, torch.Tensor) \
                else np.asarray(x)

        def pixels(img, pts):
            """Normalized points -> the integer pixels the helpers draw."""
            h, w = host(img).shape[:2]
            return (host(pts)[:, :2] * [w - 1.0, h - 1.0]).astype(int)

        # warm the card's runner path (batch-1 forwards) before any timing
        Evaluator(EvalConfig(
            model_type="Alike", task_type="repeatability",
            data_params=tasks["repeatability"],
            extractor_params={"nms_dist": 6, "border_dist": 8, "top_k": K},
            output_dir=os.path.join(root, "warm")), DEVICE).run()
        for task, dp_ in tasks.items():
            runs = {}
            for side, dev_ in (("card", DEVICE), ("cpu", "cpu")):
                d = os.path.join(root, task, side)
                if os.path.isdir(d):
                    for f in os.listdir(d):
                        os.remove(os.path.join(d, f))
                cfg = EvalConfig(
                    model_type="Alike", task_type=task, data_params=dp_,
                    extractor_params={"nms_dist": 6, "border_dist": 8,
                                      "top_k": K, "threshold": 0,
                                      "min_score": 0.0},
                    matcher_params={"type": "brute_force",
                                    "brute_force_params": {
                                        "max_distance": 5.0}},
                    task_params={"save_images": True}, output_dir=d)
                calls = {}
                t0 = time.perf_counter()
                with recording(Evaluator, "_dump_keypoints") as kc, \
                        recording(Evaluator, "_dump_matches") as mc, \
                        recording(Evaluator, "_dump_epipolar") as ec:
                    ev = Evaluator(cfg, dev_)
                    res = ev.run()
                    ms = (time.perf_counter() - t0) * 1e3 / SAVE_PAIRS
                    if task == "repeatability" and plt_ok:
                        ev.save_metric_plot(res["per_pair_repeatability"],
                                            "repeatability")
                # what each PNG draws: the valid keypoints' pixels, the
                # matched pairs' pixels, the epipolar points (the lines
                # are drawn from them through the same F)
                for a, _ in kc:
                    calls[f"{a[1]}_repeatability_{a[5]}.png"] = [
                        pixels(a[2], a[3])[host(a[4])]]
                for a, _ in mc:
                    ok = host(a[7])
                    calls[f"{a[2]}_{a[1]}.png"] = [pixels(a[3], a[5])[ok],
                                                   pixels(a[4], a[6])[ok]]
                for a, _ in ec:
                    ok = host(a[8])
                    calls[f"fund_epipolar_{a[1]}.png"] = [
                        host(a[6])[ok][:30], host(a[7])[ok][:30]]
                runs[side] = (d, calls, ms)
                if side == "card":
                    # the same run on the card without the images, warm
                    t0 = time.perf_counter()
                    Evaluator(replace(cfg, task_params={}, output_dir=(
                        os.path.join(root, task, "plain"))), dev_).run()
                    ms_none = (time.perf_counter() - t0) * 1e3 / SAVE_PAIRS
            (dc, cc, ms_c), (dh, ch, ms_h) = runs["card"], runs["cpu"]
            names = sorted(f for f in os.listdir(dc) if f.endswith(".png"))
            if names != sorted(f for f in os.listdir(dh)
                               if f.endswith(".png")) or \
                    sorted(cc) != sorted(n for n in names
                                         if n != "repeatability.png"):
                raise AssertionError(f"{task}: the PNGs differ: {names}")
            equal_in, equal_px = 0, 0
            for n in sorted(cc):
                same_in = all(np.array_equal(x, y)
                              for x, y in zip(cc[n], ch[n]))
                same_px = np.array_equal(
                    cv2.imread(os.path.join(dc, n)),
                    cv2.imread(os.path.join(dh, n)))
                equal_in += same_in
                equal_px += same_px
                if same_in and not same_px:
                    raise AssertionError(f"{task} {n}: equal inputs, "
                                         f"different pixels")
            plot = None
            if task == "repeatability" and plt_ok:
                plot = np.array_equal(
                    cv2.imread(os.path.join(dc, "repeatability.png")),
                    cv2.imread(os.path.join(dh, "repeatability.png")))
            out[task] = {"files": names, "equal_inputs": equal_in,
                         "pixel_equal": equal_px, "ms_pair_card": ms_c,
                         "ms_pair_card_without_images": ms_none,
                         "ms_pair_cpu": ms_h, "metric_plot_equal": plot}
            log(f"  {task}: {names}; drawn points equal in {equal_in} of "
                f"{len(cc)}, pixel-equal {equal_px}; metric plot equal "
                f"{plot}; {ms_c:.1f} ms a pair on the card ({ms_none:.1f} "
                f"without the images), {ms_h:.1f} on the CPU (the runner's "
                f"host clock, the synthetic rendering included)")
        if not plt_ok:
            log("  matplotlib does not import here: save_metric_plot, "
                "plot_series and plot_trajectory_3d raise ImportError, as "
                "in the JAX runner")
    return out


PAR_WORLD = 2          # thread ranks sharing the card over gloo
PAR_RUNNER_PAIRS, PAR_BATCH = 6, 4   # a batch and a 2-pair ragged tail
TP_SHARDS = (2, 4)


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def one_rank_group():
    """A one-rank process group on the card, NCCL (its collectives run the
    NCCL code path on one rank), and the Mesh over it; destroyed on
    exit. A CPU rehearsal takes gloo."""
    import torch
    import torch.distributed as dist
    from keypoint_bench_tpu_torch.parallel.mesh import world_mesh
    if DEVICE == "cuda":
        dist.init_process_group(
            "nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
            world_size=1, rank=0,
            device_id=torch.device("cuda", torch.cuda.current_device()))
    else:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{free_port()}",
            world_size=1, rank=0)
    try:
        yield world_mesh(DEVICE)
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def pair_indexed_draws():
    """Pair i of a runner's run draws its RANSAC samples from a generator
    seeded with i, on the batch path (`_batch_seeds`, then
    `parallel.evaluate.pair_samples`) as on the per-pair path and the
    ragged tail (`_sample_minimal` of one pair with that generator gives
    pair_samples' draws), so that the two paths compare pair by pair.
    Each evaluator (each thread rank) counts its own pairs; restored on
    exit."""
    import torch
    from keypoint_bench_tpu_torch.runner import Evaluator
    from keypoint_bench_tpu_torch.tasks import auc as ta
    nxt = {}
    real_seeds, real_sample = Evaluator._batch_seeds, ta._sample_minimal

    def take(generator, n):
        i = nxt.get(id(generator), 0)
        nxt[id(generator)] = i + n
        return list(range(i, i + n))

    def sample(mask, n_hyp, size, generator):
        g = torch.Generator(device=mask.device).manual_seed(
            take(generator, 1)[0])
        return real_sample(mask, n_hyp, size, g)

    Evaluator._batch_seeds = lambda self, b: take(self.generator, b)
    ta._sample_minimal = sample
    try:
        yield
    finally:
        Evaluator._batch_seeds, ta._sample_minimal = real_seeds, real_sample


@contextlib.contextmanager
def rank_calls(*targets):
    """Record every call of each (module, name) in `targets` with the
    thread (rank) that made it; the calls still run. Yields {name: [(rank,
    args, kwargs)]}; restored on exit."""
    import threading
    calls, saved = {}, []
    for module, name in targets:
        real = getattr(module, name)
        calls[name] = []

        def record(*args, _real=real, _calls=calls[name], **kwargs):
            _calls.append((threading.current_thread().name, args, kwargs))
            return _real(*args, **kwargs)

        saved.append((module, name, real))
        setattr(module, name, record)
    try:
        yield calls
    finally:
        for module, name, real in saved:
            setattr(module, name, real)


def recorded_kernels():
    """rank_calls over the wrappers of kernels A, B, D and E."""
    from keypoint_bench_tpu_torch.ops import (cuda_attention, cuda_match,
                                              cuda_nms, cuda_sample)
    return rank_calls((cuda_nms, "nms_cuda"), (cuda_sample, "sample_cuda"),
                      (cuda_match, "nn_dists_cuda"),
                      (cuda_attention, "attention_cuda"))


def hold_kernel_calls(calls, errs, what):
    """Each recorded kernel call against its plain version on the same
    inputs: A bit-equal (fast_nms), B within 1e-5 (sample_branches), D
    `check_nn` (nn_dists), E within 1e-5 of max(1, max |v|)
    (fused_attention). Returns {kernel: {rank: calls}}."""
    import torch
    from keypoint_bench_tpu_torch.ops import (cuda_attention, cuda_match,
                                              cuda_nms, cuda_sample)
    from keypoint_bench_tpu_torch.ops.attention import fused_attention
    from keypoint_bench_tpu_torch.ops.detect import fast_nms
    from keypoint_bench_tpu_torch.ops.matching import nn_dists
    from keypoint_bench_tpu_torch.ops.sparse_desc import sample_branches
    by_rank = {}
    for name, recs in calls.items():
        for rank, args, kw in recs:
            d = by_rank.setdefault(name, {})
            d[rank] = d.get(rank, 0) + 1
            if name == "nms_cuda":
                if not torch.equal(cuda_nms.nms_cuda(*args, **kw),
                                   fast_nms(*args, **kw)):
                    raise AssertionError(f"kernel A differs from fast_nms on "
                                         f"{rank}'s call ({what})")
            elif name == "sample_cuda":
                e = float((cuda_sample.sample_cuda(*args, **kw)
                           - sample_branches(*args, **kw)).abs().max())
                errs["sample"] = max(errs["sample"], e)
                if not e <= 1e-5:
                    raise AssertionError(f"kernel B on {rank}'s call "
                                         f"({what}): {e}")
            elif name == "nn_dists_cuda":
                a, b = (x.reshape(-1, *x.shape[-2:]) for x in args)
                _, e, _ = check_nn(cuda_match.nn_dists_cuda(a, b),
                                   nn_dists(a, b), a, b)
                errs["nn_match"] = max(errs["nn_match"], e)
            else:
                scale = max(1.0, float(args[2].abs().max()))
                e = float((cuda_attention.attention_cuda(*args, **kw)
                           - fused_attention(*args, **kw)).abs().max())
                errs["attention"] = max(errs["attention"], e / scale)
                if not e <= 1e-5 * scale:
                    raise AssertionError(f"kernel E on {rank}'s call "
                                         f"({what}): {e}")
        recs.clear()
    return by_rank


def same_outputs(a, b):
    """Two per-pair outputs (tensors, or tuples / dicts of them) equal bit
    for bit, NaN matching NaN."""
    import torch
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_outputs(a[k], b[k])
                                            for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(same_outputs, a, b))
    return torch.equal(a.nan_to_num(-7.0), b.nan_to_num(-7.0))


def largest_gap(a, b):
    """The largest |a - b| over every float field (NaN matching NaN)."""
    import torch
    if isinstance(a, dict):
        return max(largest_gap(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return max(map(largest_gap, a, b))
    return float((a.double() - b.double()).nan_to_num(0.0).abs().max())


def timed_ranks(fn, n_data, n_model=1, steps=3):
    """(ms a step, the collectives' share of it, the host-staged ops):
    fn(mesh) run `steps` times on each of n_data x n_model thread ranks
    over gloo on the card after one warm-up, every collective timed (it
    waits for the device first); rank 0's numbers."""
    import torch
    from keypoint_bench_tpu_torch.parallel.mesh import (collective_seconds,
                                                        thread_ranks)

    def run(mesh):
        fn(mesh)
        mesh.timing = True
        mesh.stats.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn(mesh)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        return sec, collective_seconds(mesh), sorted(mesh.staged)

    sec, coll, staged = thread_ranks(run, n_data, n_model,
                                     device=DEVICE)[0]
    return sec / steps * 1e3, coll / sec, staged


def timed_mesh(fn, mesh, steps=3):
    """timed_ranks on one given mesh (the one-rank NCCL group)."""
    import torch
    from keypoint_bench_tpu_torch.parallel.mesh import collective_seconds
    fn(mesh)
    mesh.timing = True
    mesh.stats.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn(mesh)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    mesh.timing = False
    return sec / steps * 1e3, collective_seconds(mesh) / sec, sorted(
        mesh.staged)


def dp_phase(title, make_step, direct, batch, seeds, kernels, errs, card):
    """One data-parallel step (phases 50-52) at world 1 (the one-rank
    NCCL group) and world PAR_WORLD (gloo ranks sharing the card), the
    launch counts reset just before each run and read just after, kernels
    A, B, D held on every rank's own calls: world 1 bit-equal to the
    one-rank batched step `direct(batch, seeds)` on the whole batch, and
    every rank of world PAR_WORLD to it on each rank's block (the forward
    runs on the block: its maps may depend on the batch size); the gap
    between the two worlds printed; each timed. Returns the phase's
    numbers."""
    import torch
    from keypoint_bench_tpu_torch.parallel.mesh import thread_ranks
    out = {}
    n = len(seeds)
    with phase(title):
        want1 = direct(batch, seeds)
        with one_rank_group() as mesh:
            reset_launches()
            with recorded_kernels() as calls:
                got1 = make_step(mesh)(*batch, seeds)
                torch.cuda.synchronize()
            launches1 = read_launches()
            held1 = hold_kernel_calls(calls, errs, f"{title}, world 1")
            ms1, share1, staged1 = timed_mesh(
                lambda m: make_step(m)(*batch, seeds), mesh)
        if not same_outputs(got1, want1):
            raise AssertionError(f"{title}: world 1 differs from the "
                                 f"one-rank batched step")
        b = n // PAR_WORLD
        want2 = [direct([x[r * b:(r + 1) * b] for x in batch],
                        seeds[r * b:(r + 1) * b]) for r in range(PAR_WORLD)]
        reset_launches()
        with recorded_kernels() as calls:
            got2 = thread_ranks(lambda mesh: make_step(mesh)(*batch, seeds),
                                PAR_WORLD, device=DEVICE)
            torch.cuda.synchronize()
        launches2 = read_launches()
        held2 = hold_kernel_calls(calls, errs, f"{title}, world {PAR_WORLD}")
        ms2, share2, staged2 = timed_ranks(
            lambda m: make_step(m)(*batch, seeds), PAR_WORLD)
        for r, g in enumerate(got2):
            blocks = [
                (tuple(x[r_ * b:(r_ + 1) * b] for x in g)
                 if isinstance(g, tuple) else
                 {k: v[r_ * b:(r_ + 1) * b] for k, v in g.items()}
                 if isinstance(g, dict) else g[r_ * b:(r_ + 1) * b])
                for r_ in range(PAR_WORLD)]
            if not all(same_outputs(x, y) for x, y in zip(blocks, want2)):
                raise AssertionError(f"{title}: rank {r} of world "
                                     f"{PAR_WORLD} differs from the one-rank "
                                     f"step on the blocks")
        gap = largest_gap(got2[0], got1)
        means = [round(float(x.float().nanmean()), 4) for x in (
            got1.values() if isinstance(got1, dict) else
            got1 if isinstance(got1, tuple) else got1.unbind(-1))]
        for k in kernels:
            if not (launches1[k] > 0 and launches2[k] > 0):
                raise AssertionError(f"{title}: kernel {k} not launched: "
                                     f"{launches1}, {launches2}")
        log(f"  world 1 (NCCL): bit-equal to the one-rank batched step; "
            f"per-pair outputs' means {means}; launches {launches1}; kernel calls held by rank {held1}; "
            f"{ms1:.3f} ms a step, collectives {share1:.4f} of it, "
            f"host-staged {staged1 or 'none'}")
        log(f"  world {PAR_WORLD} (gloo, one card): every rank bit-equal to "
            f"the one-rank step on the {b}-pair blocks; launches "
            f"{launches2}; kernel calls held by rank {held2}; {ms2:.3f} ms "
            f"a step, collectives {share2:.4f} of it, host-staged "
            f"{staged2 or 'none'}; largest gap to world 1 {gap:.3g} on "
            f"{card}")
        out.update({"launches_world1": {k: launches1[k] for k in kernels},
                    f"launches_world{PAR_WORLD}": {k: launches2[k]
                                                   for k in kernels},
                    "ms_world1": ms1, f"ms_world{PAR_WORLD}": ms2,
                    "collective_share_world1": share1,
                    f"collective_share_world{PAR_WORLD}": share2,
                    "host_staged": staged2, "output_means": means,
                    f"gap_world{PAR_WORLD}_vs_world1": gap})
    return out


def parallel_phases(dev, card, errs, ctx):
    """The parallel layer on one card (phases 50-56): the data-parallel
    repeatability, MHA and AUC steps; the runner's batch paths; the
    distributed Schur BA and refine_window(mesh); the sequence-sharded VO
    solves; head-sharded LightGlue. Each at world 1 (one-rank NCCL group)
    and on ranks that share the card over gloo (threads of this process),
    the launch counts reset just before each path and read just after,
    the kernels held on every rank's own calls. Returns the numbers for
    the parallel and kernels JSON lines."""
    from dataclasses import replace

    import numpy as np
    import torch

    from keypoint_bench_tpu_torch.ba.distributed import (
        ba_solve_distributed, gather_points)
    from keypoint_bench_tpu_torch.ba.gauss_newton import (lm_iterations,
                                                          reprojection_errors)
    from keypoint_bench_tpu_torch.models import get_model
    from keypoint_bench_tpu_torch.models.lightglue import (
        lightglue_forward, lightglue_scores, sample_descriptors_lg)
    from keypoint_bench_tpu_torch.datasets.registry import \
        register_preloaded
    from keypoint_bench_tpu_torch.ops.detect import DetectParams
    from keypoint_bench_tpu_torch.parallel import evaluate as pev
    from keypoint_bench_tpu_torch.parallel.lightglue_tp import (
        lightglue_forward_tp, shard_lightglue_params)
    from keypoint_bench_tpu_torch.parallel.mesh import thread_ranks
    from keypoint_bench_tpu_torch.parallel.vo_sharded import \
        sharded_vo_pair_solves
    from keypoint_bench_tpu_torch.pipeline import detect_frames, vo_step
    from keypoint_bench_tpu_torch.runner import EvalConfig, Evaluator
    from keypoint_bench_tpu_torch.tasks.vo_ba import (build_ba_problem,
                                                      gate_window)
    from keypoint_bench_tpu_torch.weights import load_params

    t_start = time.perf_counter()
    out = {}
    dp = DetectParams(nms_dist=6, border_dist=8, top_k=K)
    items = ctx["items"]
    homo = [np.stack([f(x) for x in items]) for f in (
        lambda x: x["image0"], lambda x: x["image1"],
        lambda x: x["warp01_params"]["homography_matrix"],
        lambda x: x["warp10_params"]["homography_matrix"],
        lambda x: [float(x["warp01_params"]["width"]),
                   float(x["warp01_params"]["height"])],
        lambda x: float(x["warp01_params"]["resize"]))]
    seeds = list(range(len(items)))
    for name, sparse in (("Alike", False), ("Alike_s2d", True)):
        model = get_model(name)(load_params(name, device=dev)).eval()
        out[f"eval_{name}"] = dp_phase(
            f"50. sharded_eval_step, {name}{' (sparse, B)' if sparse else ''}"
            f", {len(items)} homography pairs at {SIZE}^2, K={K}",
            lambda mesh: pev.sharded_eval_step(mesh, model, dp,
                                               sparse=sparse),
            lambda b, s: pev.batched_repeatability_step(
                model, dp, *b, s, sparse=sparse, device=dev),
            homo, seeds, ("nms", "nn_match") + (("sample",) if sparse
                                                else ()), errs, card)
        if name == "Alike":
            alike = model
    sp_model = ctx["sp_model"]
    out["mha"] = dp_phase(
        f"51. sharded_mha_step, SuperPoint + brute force, {len(items)} "
        f"pairs at {SIZE}^2",
        lambda mesh: pev.sharded_mha_step(mesh, sp_model, dp),
        lambda b, s: pev.batched_mha_step(sp_model, dp, *b, s, device=dev),
        homo[:5], seeds, ("nms", "nn_match"), errs, card)
    a0, a1, Ks, poses, _ = ctx["auc"]
    se3 = [x.cpu().numpy() for x in (a0, a1, Ks, Ks, poses)]
    out["auc"] = dp_phase(
        f"52. sharded_auc_step, ALIKE-t + brute force, {len(se3[0])} SE3 "
        f"pairs at {SIZE}^2, n_hyp {AUC_NHYP}",
        lambda mesh: pev.sharded_auc_step(mesh, alike, dp),
        lambda b, s: pev.batched_auc_step(alike, dp, *b, s, device=dev),
        se3, list(range(len(se3[0]))), ("nms", "nn_match"), errs, card)

    with phase(f"53. the runner's batch paths: {PAR_RUNNER_PAIRS} pairs, "
               f"batch_size {PAR_BATCH}, at world 1 and {PAR_WORLD}, "
               f"against the per-pair run"):
        base = dict(extractor_params={"nms_dist": 6, "border_dist": 8,
                                      "top_k": K, "threshold": 0,
                                      "min_score": 0.0},
                    matcher_params={"type": "brute_force",
                                    "brute_force_params": {
                                        "max_distance": 5.0}})
        register_preloaded("chip_smoke_par_homo",
                           items[:PAR_RUNNER_PAIRS])
        register_preloaded("chip_smoke_par_se3",
                           ctx["auc_items"][:PAR_RUNNER_PAIRS])
        homo_data = {"type": "preloaded", "name": "chip_smoke_par_homo"}
        runs = {
            "repeatability": dict(model_type="Alike",
                                  task_type="repeatability",
                                  data_params=homo_data,
                                  task_params={"th": 3.0}),
            "MHA": dict(model_type="Alike", task_type="MHA",
                        data_params=homo_data,
                        task_params={"th": [3, 5, 7]}),
            "AUC": dict(model_type="Alike", task_type="AUC",
                        data_params={"type": "preloaded",
                                     "name": "chip_smoke_par_se3"},
                        task_params={"th": [5, 10, 20]})}
        out["runner"] = {}

        def journal(name):
            """A runner's progress.jsonl records, in pair order."""
            with open(os.path.join(ROOT, "output", f"chip_smoke_par_{name}",
                                   "progress.jsonl")) as f:
                recs = [json.loads(line) for line in f]
            return sorted((r for r in recs if "i" in r), key=lambda r: r["i"])

        for task, kw in runs.items():
            def cfg(bs, tag):
                c = EvalConfig(**{**base, **kw}, output_dir=os.path.join(
                    ROOT, "output", f"chip_smoke_par_{task}_{tag}"))
                c.data_params = {**c.data_params, "batch_size": bs}
                return c

            # AUC's errors move with the RANSAC draws: its runs draw pair
            # i's from seed i on both paths
            draws = (pair_indexed_draws if task == "AUC"
                     else contextlib.nullcontext)
            with draws():
                per_pair = Evaluator(cfg(1, "pp"), DEVICE).run()
            reset_launches()
            with recorded_kernels() as calls, draws():
                one = Evaluator(cfg(PAR_BATCH, "w1"), DEVICE).run()
                torch.cuda.synchronize()
            launches = read_launches()
            held = hold_kernel_calls(calls, errs, f"{task} runner")
            t0 = time.perf_counter()
            with draws():
                two = thread_ranks(lambda mesh: Evaluator(
                    cfg(PAR_BATCH, f"w{PAR_WORLD}"), DEVICE,
                    mesh=mesh).run(), PAR_WORLD, device=DEVICE)
            sec2 = time.perf_counter() - t0
            if any(r != two[0] for r in two):
                raise AssertionError(f"the {task} runner's ranks differ")
            if task == "repeatability":
                key, tol = "per_pair_repeatability", 2e-3
            elif task == "MHA":
                key, tol = "per_pair", None
            else:
                key, tol = "per_pair_error", None
            a, b, c = (np.asarray(r[key], np.float64)
                       for r in (one, two[0], per_pair))
            gaps = [float(np.abs(a - c).max()), float(np.abs(b - c).max()),
                    float(np.abs(a - b).max())]
            log(f"  {task}: batch path {one[key] if task != 'MHA' else [one[f'MHA@{t}'] for t in (3, 5, 7)]}; "
                f"per pair {per_pair[key] if task != 'MHA' else [per_pair[f'MHA@{t}'] for t in (3, 5, 7)]}; "
                f"largest per-pair gap world 1 / world {PAR_WORLD} to the "
                f"per-pair run, and between them: {gaps}; launches (world "
                f"1) {launches}; kernel calls held {held}; world "
                f"{PAR_WORLD} in {sec2:.2f} s")
            if not len(a) == len(b) == len(c) == PAR_RUNNER_PAIRS:
                raise AssertionError(f"the {task} batch path lost pairs")
            if launches["nms"] <= 0 or launches["nn_match"] <= 0:
                raise AssertionError(f"the {task} batch path missed kernel "
                                     f"A or D: {launches}")
            if task == "repeatability" and not max(gaps[:2]) <= tol:
                raise AssertionError("the repeatability batch path differs "
                                     "from the per-pair run")
            if task == "MHA" and not all(
                    abs(r[f"MHA@{t}"] - per_pair[f"MHA@{t}"])
                    <= 1.0 / PAR_RUNNER_PAIRS + 1e-6
                    for r in (one, two[0]) for t in (3, 5, 7)):
                raise AssertionError("the MHA batch path differs from the "
                                     "per-pair run by more than one pair")
            if task == "AUC":
                # pair by pair on the same draws: the failed pairs equal,
                # errors within 1 degree where the inlier counts are
                inl = [[r["inliers"] for r in journal(f"AUC_{tag}")]
                       for tag in ("w1", "pp")]
                same = np.asarray(inl[0]) == np.asarray(inl[1])
                log(f"  AUC inliers batch path {inl[0]}, per pair {inl[1]}")
                if not (np.isfinite(a).all() and np.isfinite(b).all()
                        and min(one["AUC_inliers"], two[0]["AUC_inliers"])
                        > 0.6 * per_pair["AUC_inliers"]
                        and np.array_equal(a == 180.0, c == 180.0)
                        and same.sum() >= PAR_RUNNER_PAIRS // 2
                        and np.abs(a - c)[same].max(initial=0.0) <= 1.0):
                    raise AssertionError("the AUC batch path misses its "
                                         "gates")
            out["runner"][task] = {"batch": one[key],
                                   f"world{PAR_WORLD}": two[0][key],
                                   "per_pair": per_pair[key], "gaps": gaps,
                                   "launches": {k: launches[k] for k in (
                                       "nms", "nn_match")}}

    frames, K_cam, scales, _ = ctx["vo"]
    vo_model = get_model("Alike_s2d")(load_params("Alike_s2d", device=dev))
    kpts_px, tracks, R_w2c, t_w2c = ctx["vo_window"]

    def gen():
        return torch.Generator(device=dev).manual_seed(0)

    with phase("54. ba_solve_distributed on the VO step's window: card vs "
               "CPU, one-rank group vs ba_solve; refine_window(mesh) vs the "
               "one-rank refinement"):
        out["ba"] = {}
        prob_c = build_ba_problem(kpts_px, tracks, R_w2c, t_w2c, K_cam,
                                  device=dev)
        prob_h = build_ba_problem(kpts_px, tracks, R_w2c, t_w2c, K_cam,
                                  device="cpu")
        with one_rank_group() as mesh:
            g, _ = gate_window(prob_c)
            R1, t1, s1, meta = ba_solve_distributed(mesh, g, 8, 1e-2,
                                                    huber_delta=2.0)
            Rb, tb, pb, _ = lm_iterations(g, 8, 1e-2, huber_delta=2.0)
            p1 = gather_points(s1, meta, g.points.shape[0])
            equal1 = (torch.equal(R1, Rb) and torch.equal(t1, tb)
                      and torch.equal(p1, pb))
            log(f"  one-rank NCCL group: equal to ba_solve {equal1}")
            if not equal1:
                raise AssertionError("ba_solve_distributed on one rank "
                                     "differs from ba_solve")
        for dt, err_tol, pose_tol in ((torch.float32, 1e-3, 1e-3),
                                      (torch.float64, 1e-6, 1e-6)):
            sols = []
            for pr, where in ((prob_c, DEVICE), (prob_h, "cpu")):
                pr = replace(pr, R=pr.R.to(dt), t=pr.t.to(dt),
                             points=pr.points.to(dt), uv=pr.uv.to(dt),
                             K=pr.K.to(dt))
                g, _ = gate_window(pr)
                R, t, s_pts, meta = thread_ranks(
                    lambda mesh: ba_solve_distributed(mesh, g, 8, 1e-2,
                                                      huber_delta=2.0),
                    PAR_WORLD, device=where)[0]
                p = gather_points(s_pts, meta, g.points.shape[0])
                err = float(reprojection_errors(replace(
                    g, R=R, t=t, points=p)).sum() / g.mask.sum())
                sols.append(([y.cpu().numpy() for y in (R, t, p)], err))
            (sol_c, e_c), (sol_h, e_h) = sols
            s, gap_r, gap_c, gap_p = gauge_gap(sol_c, sol_h)
            name = str(dt).split(".")[-1]
            out["ba"][name] = {"err_after": [e_c, e_h], "scale": s,
                               "rotation_gap": gap_r, "centre_gap": gap_c,
                               "point_gap": gap_p}
            log(f"  {name}, {PAR_WORLD} ranks: reproj {e_c:.9f} px on the "
                f"card, {e_h:.9f} on the CPU; the free scale about camera 0 "
                f"{s:.9f}, then rotation gap {gap_r:.3g}, centre gap "
                f"{gap_c:.3g}, point gap {gap_p:.3g} of max(1, |X|)")
            if not (abs(e_c - e_h) <= err_tol and abs(s - 1.0) <= 0.05
                    and max(gap_r, gap_c) <= pose_tol
                    and (dt == torch.float32 or gap_p <= pose_tol)):
                raise AssertionError(f"ba_solve_distributed card vs CPU in "
                                     f"{name}")
        ref = vo_step(vo_model, frames, K_cam, scales, dp, gen(), VO_MAXD,
                      VO_NHYP, ba_refine=True, device=dev)
        for tag, run in (
                ("one-rank NCCL group", lambda: _with_group(
                    lambda mesh: vo_step(vo_model, frames, K_cam, scales,
                                         dp, gen(), VO_MAXD, VO_NHYP,
                                         ba_refine=True, device=dev,
                                         mesh=mesh))),
                (f"{PAR_WORLD} ranks over gloo", lambda: thread_ranks(
                    lambda mesh: vo_step(vo_model, frames, K_cam, scales,
                                         dp, gen(), VO_MAXD, VO_NHYP,
                                         ba_refine=True, device=dev,
                                         mesh=mesh), PAR_WORLD,
                    device=DEVICE)[0])):
            got = run()
            s, gap_r, gap_c, _ = gauge_gap(
                (got["ba_R_w2c"], got["ba_t_w2c"], got["ba_points"]),
                (ref["ba_R_w2c"], ref["ba_t_w2c"], ref["ba_points"]))
            d_err = abs(got["ba_reproj_after"] - ref["ba_reproj_after"])
            log(f"  refine_window(mesh) in vo_step, {tag}: {got['ba_tracks']}"
                f" tracks, reproj {got['ba_reproj_before']:.4f} -> "
                f"{got['ba_reproj_after']:.6f} px (one rank "
                f"{ref['ba_reproj_after']:.6f}); scale {s:.6f}, rotation gap "
                f"{gap_r:.3g}, centre gap {gap_c:.3g}")
            # tests/test_vo_ba.py's gates (the mesh case): another
            # summation order moves the LM decisions and the free scale
            if not (got["ba_tracks"] == ref["ba_tracks"]
                    and got["ba_reproj_after"] < got["ba_reproj_before"]
                    and d_err < 0.05 * max(ref["ba_reproj_after"], 0.1)
                    and gap_r <= 2e-3):
                raise AssertionError(f"refine_window(mesh), {tag}, differs "
                                     f"from the one-rank refinement")
            out["ba"][f"refine_window_{tag.split()[0]}"] = {
                "err_after": got["ba_reproj_after"],
                "err_after_one_rank": ref["ba_reproj_after"],
                "rotation_gap": gap_r}
        ms_one = host_ms(lambda: vo_step(vo_model, frames, K_cam, scales, dp,
                                         gen(), VO_MAXD, VO_NHYP,
                                         ba_refine=True, device=dev), iters=3)
        ms_two, share, staged = timed_ranks(
            lambda mesh: vo_step(vo_model, frames, K_cam, scales, dp, gen(),
                                 VO_MAXD, VO_NHYP, ba_refine=True,
                                 device=dev, mesh=mesh), PAR_WORLD)
        out["ba"].update({"vo_step_ba_ms_one_rank": ms_one,
                          f"vo_step_ba_ms_world{PAR_WORLD}": ms_two,
                          "collective_share": share, "host_staged": staged})
        log(f"  vo_step with BA: one rank {ms_one:.3f} ms; {PAR_WORLD} ranks "
            f"with the distributed window {ms_two:.3f} ms, collectives "
            f"{share:.4f} of it, host-staged {staged or 'none'} on {card}")

    with phase(f"55. sharded_vo_pair_solves: {VO_FRAMES} frames at {SIZE}^2"
               f" against vo_step's pair poses on the same samples"):
        with torch.inference_mode():
            _, descs, kpts, valid = detect_frames(vo_model, frames, dp, dev,
                                                  True)
        first = vo_step(vo_model, frames, K_cam, scales, dp, gen(), VO_MAXD,
                        VO_NHYP, device=dev)
        vseeds = list(range(VO_FRAMES))
        samples = pev.pair_samples(first["match_mask"], vseeds, VO_NHYP, 8)
        ref = vo_step(vo_model, frames, K_cam, scales, dp, None, VO_MAXD,
                      VO_NHYP, samples=samples, device=dev)
        args = (kpts, valid, descs, vseeds, K_cam[0, 0], K_cam[0, 2],
                K_cam[1, 2], SIZE, SIZE, VO_MAXD, VO_NHYP)
        out["vo_sharded"] = {}
        for tag in ("world1", f"world{PAR_WORLD}"):
            reset_launches()
            with recorded_kernels() as calls:
                if tag == "world1":
                    R, t, ok = _with_group(
                        lambda mesh: sharded_vo_pair_solves(mesh, *args))
                else:
                    R, t, ok = thread_ranks(
                        lambda mesh: sharded_vo_pair_solves(mesh, *args),
                        PAR_WORLD, device=DEVICE)[0]
                torch.cuda.synchronize()
            launches = read_launches()
            held = hold_kernel_calls(calls, errs, f"sharded VO, {tag}")
            gap_r = float((R - ref["R_rel"]).abs().max())
            gap_t = float((t - ref["t_rel"]).abs().max())
            log(f"  {tag}: ok {int(ok.sum())} of {VO_FRAMES} (vo_step "
                f"{int(ref['ok'].sum())}); largest gap to vo_step's pair "
                f"poses: R {gap_r:.3g}, t {gap_t:.3g}; launches {launches};"
                f" kernel calls held {held}")
            if launches["nn_match"] <= 0:
                raise AssertionError(f"sharded VO ({tag}) missed kernel D")
            if not (torch.equal(ok, ref["ok"]) and gap_r <= 1e-4
                    and gap_t <= 1e-4):
                raise AssertionError(f"sharded VO ({tag}) differs from "
                                     f"vo_step's pair poses")
            out["vo_sharded"][tag] = {"launches_nn_match":
                                      launches["nn_match"],
                                      "gap_R": gap_r, "gap_t": gap_t}
        ms, share, staged = timed_ranks(
            lambda mesh: sharded_vo_pair_solves(mesh, *args), PAR_WORLD)
        ms_ref = cuda_ms(lambda: vo_step(vo_model, frames, K_cam, scales, dp,
                                         None, VO_MAXD, VO_NHYP,
                                         samples=samples, device=dev),
                         iters=2, warmup=1)
        out["vo_sharded"].update({f"ms_world{PAR_WORLD}": ms,
                                  "collective_share": share,
                                  "host_staged": staged,
                                  "vo_step_ms": ms_ref})
        log(f"  {PAR_WORLD} ranks: {ms:.3f} ms the solves (vo_step whole "
            f"{ms_ref:.3f} ms), collectives {share:.4f} of it, host-staged "
            f"{staged or 'none'} on {card}")

    lg = ctx["lightglue"]
    sk0, sva, sdm0, sk1, svb, sdm1 = ctx["superpoint"]
    with torch.inference_mode():
        p0, p1 = sk0[0, :, :2] * (SIZE - 1.0), sk1[0, :, :2] * (SIZE - 1.0)
        lg_args = (p0, sva[0], sample_descriptors_lg(p0, sdm0[0], 8), p1,
                   svb[0], sample_descriptors_lg(p1, sdm1[0], 8))
    with phase(f"56. head-sharded LightGlue: D = 256, 4 heads, 9 layers, "
               f"K = {K}, over {TP_SHARDS} model ranks against the dense "
               f"forward"):
        out["tp"] = {}
        m0_d, ms_d, _ = lightglue_forward(lg, *lg_args)
        sc_d = lightglue_scores(lg, *lg_args, n_layers=2)
        ms_dense = cuda_ms(lambda: lightglue_forward(lg, *lg_args), iters=5)
        for n in TP_SHARDS:
            sp = shard_lightglue_params(lg, n)
            reset_launches()
            with recorded_kernels() as calls:
                res = thread_ranks(
                    lambda mesh: lightglue_forward_tp(mesh, sp, *lg_args),
                    1, n, device=DEVICE)
                torch.cuda.synchronize()
            launches = read_launches()["attention"]
            shapes = sorted({tuple(a[0].shape) for _, a, _ in
                             calls["attention_cuda"]})
            held = hold_kernel_calls(calls, errs, f"TP LightGlue, {n}")

            def scores2(mesh):
                r = mesh.model_rank
                p = {k: (v[r] if v.dim() > lg[k].dim() else v)
                     for k, v in sp.items()}

                def proj(p, name, x):
                    part = torch.nn.functional.linear(x, p[f"{name}.weight"])
                    return mesh.all_reduce(part, "model") + p[f"{name}.bias"]

                return lightglue_scores(p, *lg_args, n_layers=2,
                                        num_heads=4 // n, out=proj)

            sc_t = thread_ranks(scores2, 1, n, device=DEVICE)[0]
            rel = float((sc_t - sc_d).norm() / sc_d.norm())
            m0_t, ms_t, _ = res[0]
            agree = float((m0_t == m0_d).float().mean())
            dev_ms = float((ms_t - ms_d).abs().max())
            ms_tp, share, staged = timed_ranks(
                lambda mesh: lightglue_forward_tp(mesh, sp, *lg_args), 1, n)
            log(f"  {n} model ranks: matches agree {agree:.4f}, mscores "
                f"within {dev_ms:.3g}; 2-layer scores {rel:.3g} of their "
                f"norm from the dense; kernel E {launches} launches at "
                f"{shapes}, calls held by rank {held}; {ms_tp:.3f} ms (dense"
                f" {ms_dense:.3f}), collectives {share:.4f} of it, "
                f"host-staged {staged or 'none'} on {card}")
            if launches != 18 * n:
                raise AssertionError(f"TP LightGlue launched kernel E "
                                     f"{launches} times on {n} ranks")
            if not (agree > 0.99 and dev_ms < 1e-3 and rel <= 1e-4
                    and all(same_outputs(r, res[0]) for r in res)):
                raise AssertionError(f"TP LightGlue on {n} ranks differs from "
                                     f"the dense forward")
            out["tp"][f"n{n}"] = {"launches_attention": launches,
                                  "match_agreement": agree,
                                  "mscore_gap": dev_ms, "scores_rel": rel,
                                  "ms": ms_tp, "ms_dense": ms_dense,
                                  "collective_share": share,
                                  "host_staged": staged}
    out["seconds"] = time.perf_counter() - t_start
    return out


RING_WORLDS = (2, 4)    # phase 57: gloo thread ranks sharing the card
SP_WORLDS = (2, 4)      # phase 58
PP_MICRO = 4            # phase 59: microbatches of config 1's 16 images


def ring_hops(mesh_stats):
    """The ring hops a timed run made (calls of `ring_shift`)."""
    return mesh_stats.get("ring_shift", (0, 0.0))[0]


def sp_pp_phases(dev, card, errs, ctx):
    """Phases 57-61: ring attention and sequence-parallel LightGlue over
    data ranks, the two-stage pipeline, export / profiling / info, and
    the runner's debug_nans. The launch counts are reset just before each
    path and read just after. Returns the numbers for the sp_pp and
    kernels JSON lines."""
    import numpy as np
    import torch

    from keypoint_bench_tpu_torch import info as kbt_info
    from keypoint_bench_tpu_torch import runner as kbt_runner
    from keypoint_bench_tpu_torch.models import get_model
    from keypoint_bench_tpu_torch.models.lightglue import (
        lightglue_forward, lightglue_scores, sample_descriptors_lg)
    from keypoint_bench_tpu_torch.ops.detect import (DetectParams,
                                                     detection_batch)
    from keypoint_bench_tpu_torch.parallel.lightglue_sp import (
        lightglue_forward_sp, lightglue_scores_sp)
    from keypoint_bench_tpu_torch.parallel.mesh import (collective_seconds,
                                                        thread_ranks)
    from keypoint_bench_tpu_torch.parallel.pipeline import (
        make_stage_mesh, pipeline_extract, two_stage_pipeline)
    from keypoint_bench_tpu_torch.parallel.ring_attention import (
        dense_attention, gather_rows, ring_attention)
    from keypoint_bench_tpu_torch.runner import EvalConfig, Evaluator
    from keypoint_bench_tpu_torch.utils.export import (export_model,
                                                       load_exported)
    from keypoint_bench_tpu_torch.utils.profiling import trace
    from keypoint_bench_tpu_torch.weights import load_params

    t_start = time.perf_counter()
    out = {}

    def timed(fn, world, steps=3):
        """(ms a step, collectives' share, ring hops a step, host-staged
        ops) of fn(mesh) on `world` gloo thread ranks, rank 0's."""
        def run(mesh):
            fn(mesh)
            mesh.timing = True
            mesh.stats.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                fn(mesh)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            return (sec, collective_seconds(mesh), ring_hops(mesh.stats),
                    sorted(mesh.staged))
        sec, coll, hops, staged = thread_ranks(run, world, device=DEVICE)[0]
        return sec / steps * 1e3, coll / sec, hops // steps, staged

    with phase(f"57. ring attention: [4, {K}, 64] over {RING_WORLDS} gloo "
               f"ranks and a one-rank NCCL group against dense_attention"):
        gen = torch.Generator(device=dev).manual_seed(57)
        q, k, v = (torch.randn((4, K, 64), device=dev, generator=gen)
                   for _ in range(3))
        valid = torch.ones(K, dtype=torch.bool, device=dev)
        valid[K - K // 25:] = False          # a padded tail
        valid[:K // max(RING_WORLDS)] = False   # rank 0's chunk at world 4
        want = dense_attention(q, k, v, valid)
        out["ring"] = {}
        for world in (1,) + RING_WORLDS:
            if world == 1:
                got, (ms, share, staged) = _with_group(lambda m: (
                    gather_rows(m, ring_attention(m, q, k, v, valid), 1),
                    timed_mesh(lambda m_: ring_attention(m_, q, k, v, valid),
                               m)))
                hops = 0
            else:
                got = thread_ranks(lambda m: gather_rows(
                    m, ring_attention(m, q, k, v, valid), 1), world,
                    device=DEVICE)[0]
                ms, share, hops, staged = timed(
                    lambda m: ring_attention(m, q, k, v, valid), world)
            err = float((got - want).abs().max())
            log(f"  world {world}: max abs err {err:.3g} against the dense "
                f"softmax; ring hops a call {hops} (3 a step), host-staged "
                f"{staged or 'none'}; {ms:.3f} ms a call, collectives "
                f"{share:.4f} of it on {card}")
            if not err <= 1e-5:
                raise AssertionError(f"ring attention at world {world}: "
                                     f"{err}")
            out["ring"][f"world{world}"] = {
                "max_abs_err": err, "ring_hops": hops, "ms": ms,
                "collective_share": share, "host_staged": staged}

    lg = ctx["lightglue"]
    sk0, sva, sdm0, sk1, svb, sdm1 = ctx["superpoint"]
    with torch.inference_mode():
        p0, p1 = sk0[0, :, :2] * (SIZE - 1.0), sk1[0, :, :2] * (SIZE - 1.0)
        lg_args = (p0, sva[0], sample_descriptors_lg(p0, sdm0[0], 8), p1,
                   svb[0], sample_descriptors_lg(p1, sdm1[0], 8))
    with phase(f"58. sequence-parallel LightGlue: D = 256, 4 heads, 9 "
               f"layers, K = {K}, over {SP_WORLDS} data ranks against the "
               f"dense forward"):
        reset_launches()
        m0_d, ms_d, _ = lightglue_forward(lg, *lg_args)
        torch.cuda.synchronize()
        dense_e = read_launches()["attention"]
        sc_d = lightglue_scores(lg, *lg_args, n_layers=2)
        ms_dense = cuda_ms(lambda: lightglue_forward(lg, *lg_args), iters=5)
        out["sp"] = {"dense_launches_attention": dense_e,
                     "ms_dense": ms_dense}
        for world in SP_WORLDS:
            reset_launches()
            res = thread_ranks(
                lambda m: lightglue_forward_sp(m, lg, *lg_args), world,
                device=DEVICE)
            torch.cuda.synchronize()
            sp_e = read_launches()["attention"]
            sc = thread_ranks(
                lambda m: lightglue_scores_sp(m, lg, *lg_args, n_layers=2),
                world, device=DEVICE)[0]
            rel = float((sc - sc_d).norm() / sc_d.norm())
            m0, msc, _ = res[0]
            gap = float((msc - ms_d).abs().max())
            ms_sp, share, hops, staged = timed(
                lambda m: lightglue_forward_sp(m, lg, *lg_args), world)
            log(f"  {world} data ranks: matches equal "
                f"{bool(torch.equal(m0, m0_d))} ({int((m0 >= 0).sum())} "
                f"matched), mscores within {gap:.3g}; 2-layer scores "
                f"{rel:.3g} of their norm from the dense; kernel E "
                f"{sp_e} launches (dense forward {dense_e}); {ms_sp:.3f} ms "
                f"(dense {ms_dense:.3f}), collectives {share:.4f} of it, "
                f"{hops} ring hops a forward, host-staged "
                f"{staged or 'none'} on {card}")
            if dense_e != 18 or sp_e != 0:
                raise AssertionError(f"kernel E launches: dense {dense_e}, "
                                     f"SP {sp_e}")
            if not (torch.equal(m0, m0_d) and gap < 2e-3 and rel <= 1e-4
                    and all(same_outputs(r, res[0]) for r in res)):
                raise AssertionError(f"SP LightGlue on {world} ranks differs "
                                     f"from the dense forward")
            out["sp"][f"world{world}"] = {
                "launches_attention": sp_e, "mscore_gap": gap,
                "scores_rel": rel, "ms": ms_sp, "collective_share": share,
                "ring_hops": hops, "host_staged": staged}

    imgs = ctx["imgs0"]
    alike = get_model("Alike")(load_params("Alike", device=dev)).eval()
    dp = DetectParams(nms_dist=6, border_dist=8, top_k=K)
    n, mb = len(imgs), len(imgs) // PP_MICRO
    with phase(f"59. two-stage pipeline: ALIKE-t on {n} images at {SIZE}^2,"
               f" {PP_MICRO} microbatches, over 2 gloo ranks"):
        xs = imgs.reshape((PP_MICRO, mb) + tuple(imgs.shape[1:]))

        def stage0(x):
            with torch.inference_mode():
                return alike(x)[0][..., 0]

        def stage1(score):
            return detection_batch(score, dp)

        seq = [stage1(stage0(x)) for x in xs]
        got = thread_ranks(lambda m: two_stage_pipeline(
            make_stage_mesh(m), stage0, stage1, xs), 2, device=DEVICE)
        for g in got:
            if not all(torch.equal(g[i][j], seq[j][i]) for i in range(2)
                       for j in range(PP_MICRO)):
                raise AssertionError("two_stage_pipeline differs from the "
                                     "sequential map")
        scores = torch.cat([stage0(x) for x in xs])
        kref, vref = detection_batch(scores, dp)
        reset_launches()
        with recorded_kernels() as calls:
            res = thread_ranks(lambda m: pipeline_extract(
                make_stage_mesh(m), alike, dp, imgs, PP_MICRO), 2,
                device=DEVICE)
            torch.cuda.synchronize()
        pp_a = read_launches()["nms"]
        held = hold_kernel_calls(calls, errs, "pipeline_extract")
        kerr = max(float((k_ - kref).abs().max()) for k_, _ in res)
        if not (kerr <= 1e-6 and all(torch.equal(v_, vref)
                                     for _, v_ in res)):
            raise AssertionError(f"pipeline_extract differs from "
                                 f"detection_batch: {kerr}")
        if pp_a != PP_MICRO:
            raise AssertionError(f"pipeline_extract launched kernel A "
                                 f"{pp_a} times")

        def dp_extract(mesh):
            b = n // mesh.n_data
            with torch.inference_mode():
                score = alike(imgs[mesh.rank * b:(mesh.rank + 1) * b])[0]
            k_, v_ = detection_batch(score, dp)
            return (torch.cat(mesh.all_gather(k_)),
                    torch.cat(mesh.all_gather(v_)))

        ms_pp, share_pp, _, staged = timed(lambda m: pipeline_extract(
            make_stage_mesh(m), alike, dp, imgs, PP_MICRO), 2)
        ms_dp, share_dp, _, _ = timed(dp_extract, 2)
        hop_bytes = PP_MICRO * scores[:mb].numel() * scores.element_size()
        ms_eval = ctx["eval_alike"]["ms_world2"]
        log(f"  bit-equal to the sequential map (both ranks); keypoints "
            f"within {kerr:.3g} of detection_batch, masks equal; kernel A "
            f"{pp_a} launches (one a microbatch, on stage 1), calls held "
            f"{held}; {ms_pp:.3f} ms the pipeline (collectives "
            f"{share_pp:.4f}) against {ms_dp:.3f} ms data-parallel "
            f"extraction on the same 2 ranks (collectives {share_dp:.4f}; "
            f"phase 50's ALIKE-t step {ms_eval:.3f} ms for the pairs); "
            f"{hop_bytes} bytes of activations through the host "
            f"({staged or 'none'} staged) on {card}")
        out["pipeline"] = {"launches_nms": pp_a, "kpts_gap": kerr,
                           "ms_pipeline": ms_pp, "ms_data_parallel": ms_dp,
                           "collective_share": share_pp,
                           "bytes_staged": hop_bytes, "host_staged": staged,
                           "ms_phase50_world2": ms_eval}

    with phase(f"60. export, model_cost, info and trace: ALIKE-t at "
               f"{SIZE}^2"):
        path = export_model("Alike", os.path.join(
            ROOT, "output", "chip_smoke_export", "alike.pt2"),
            (1, SIZE, SIZE, 3), device=dev)
        call = load_exported(path)
        img = imgs[:1].float() / 255.0 if imgs.dtype == torch.uint8 \
            else imgs[:1]
        got = call(img)
        with torch.inference_mode():
            want = alike(img)
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        if not err <= 1e-5:
            raise AssertionError(f"the exported ALIKE-t differs: {err}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            kbt_info.main(["Alike", "--size", str(SIZE), "--latency",
                           "--device", DEVICE])
        info = json.loads(buf.getvalue())
        tr = trace(alike, (img,), os.path.join(ROOT, "output",
                                               "chip_smoke_trace"))
        with open(tr) as f:
            events = json.load(f)["traceEvents"]
        on_card = sum(1 for e in events if e.get("cat") == "kernel")
        log(f"  export: {os.path.getsize(path)} bytes, reloaded forward "
            f"within {err:.3g} of eager; info: {json.dumps(info)}; trace "
            f"{os.path.getsize(tr)} bytes, {len(events)} events, {on_card} "
            f"device kernels on {card}")
        if not (os.path.getsize(tr) > 0 and events):
            raise AssertionError("the trace is empty")
        out["export"] = {"bytes": os.path.getsize(path), "max_abs_err": err,
                         "info": info, "trace_events": len(events),
                         "trace_device_kernels": on_card}

    with phase("61. debug_nans: synthetic repeatability and MHA (SuperPoint "
               "+ light_glue) with and without it; a planted NaN raises"):
        rep_cfg = EvalConfig.from_yaml(os.path.join(
            ROOT, "configs", "repeatability_synthetic.yaml"))
        rep_cfg.output_dir = os.path.join(ROOT, "output", "chip_smoke_nans")
        mha_cfg = EvalConfig(
            model_type="SuperPoint", task_type="MHA",
            data_params={"type": "synthetic_homography", "num_pairs": 4,
                         "image_size": SIZE},
            extractor_params={"nms_dist": 6, "border_dist": 8, "top_k": K,
                              "threshold": 0, "min_score": 0.0},
            matcher_params={"type": "light_glue"},
            task_params={"th": [3, 5, 7]}, weights_dir=ctx["weights_dir"],
            output_dir=os.path.join(ROOT, "output", "chip_smoke_nans"))
        out["debug_nans"] = {}
        for name, cfg in (("repeatability", rep_cfg), ("MHA", mha_cfg)):
            plain = Evaluator(cfg, DEVICE).run()
            reset_launches()
            t0 = time.perf_counter()
            checked = Evaluator(dataclasses.replace(cfg, debug_nans=True),
                                DEVICE).run()
            sec = time.perf_counter() - t0
            got = read_launches()
            same = (json.dumps(checked, sort_keys=True, default=float)
                    == json.dumps(plain, sort_keys=True, default=float))
            log(f"  {name}: with debug_nans equal to the run without it "
                f"{same}; launches {got}; {sec:.2f} s (every operation's "
                f"and kernel's output checked)")
            if not same:
                raise AssertionError(f"{name} with debug_nans differs")
            out["debug_nans"][name] = {"launches": got, "seconds": sec}

        real_get = kbt_runner.get_dataset

        def planted(params):
            ds = real_get(params)

            class NanPixel:
                def __len__(self):
                    return len(ds)

                def __getitem__(self, i):
                    item = dict(ds[i])
                    if i == 0:
                        img = np.array(item["image0"], np.float32)
                        img[SIZE // 2, SIZE // 2, 0] = np.nan
                        item["image0"] = img
                    return item
            return NanPixel()

        kbt_runner.get_dataset = planted
        try:
            Evaluator(dataclasses.replace(rep_cfg, debug_nans=True),
                      DEVICE).run()
        except FloatingPointError as e:
            log(f"  a NaN pixel raises FloatingPointError: {e}")
            out["debug_nans"]["planted"] = str(e)
        else:
            raise AssertionError("a planted NaN pixel did not raise under "
                                 "debug_nans")
        finally:
            kbt_runner.get_dataset = real_get
    out["seconds"] = time.perf_counter() - t_start
    return out


DISK_LG_IMAGES = 3      # phase 63's HPatches tree: 2 pairs a sequence


def decision_margins(s, valid0, valid1, filter_threshold=0.1):
    """How far each row's match decision in log assignment scores s
    [K0, K1] lies from flipping: the least of the gap between the row's
    best and second-best score, the gap that decides whether the row is
    its best column's arg-max, and, for a mutual pair, the distance of its
    score from log(filter_threshold). inf outside valid0."""
    import math

    import torch
    top = s.topk(2, dim=-1)
    j, best = top.indices[:, 0], top.values[:, 0]
    col = s.topk(2, dim=-2)
    mutual = col.indices[0, j] == torch.arange(len(s), device=s.device)
    col_gap = torch.where(mutual, col.values[0, j] - col.values[1, j],
                          col.values[0, j] - best)
    inf = torch.full_like(best, math.inf)
    thr = torch.where(mutual, (best - math.log(filter_threshold)).abs(), inf)
    gap = torch.minimum(torch.minimum(best - top.values[:, 1], col_gap), thr)
    return torch.where(valid0, gap, inf)


def largest(t):
    """t's largest entry, 0 for an empty t."""
    return float(t.max()) if t.numel() else 0.0


def parted_rows(m_a, m_b, ref, valid0, valid1, err):
    """(rows whose match indices m_a and m_b differ, those of them that a
    rounding error of err in every score of ref cannot explain: a decision
    margin in ref above 2 err, since each of two scores may be off by
    err)."""
    differ = m_a.cpu() != m_b.cpu()
    far = decision_margins(ref, valid0.cpu(), valid1.cpu()) > 2 * err
    return int(differ.sum()), int((differ & far).sum())


def adaptive_decisions(stats, i_fin):
    """Per deciding layer of an adaptive forward: (the masks it decided
    over, whether it stopped there, the masks after it), on the host."""
    vals = stats["values"]
    out = []
    for i, v in enumerate(vals):
        after = vals[i + 1][5:7] if i + 1 < len(vals) else stats["masks"]
        out.append((v[5].cpu(), v[6].cpu(), i_fin == i + 1, after[0].cpu(),
                    after[1].cpu()))
    return out


def same_decision(a, b):
    import torch
    return a[2] == b[2] and torch.equal(a[3], b[3]) and torch.equal(a[4],
                                                                    b[4])


def value_gap(stats, ref, i):
    """The largest |v - v_ref| at deciding layer i over the tokens valid
    there (ref's masks): of the confidences and matchabilities, and of the
    confident share."""
    import torch
    v, w = stats["values"][i], ref["values"][i]
    a0, a1 = w[5].cpu(), w[6].cpu()
    gap = 0.0
    for x, y, m in zip(v[:4], w[:4], (a0, a1, a0, a1)):
        d = (x.cpu().double() - y.cpu().double()).abs()
        gap = max(gap, float(torch.where(m, d, torch.zeros_like(d)).max()))
    return max(gap, abs(float(v[4]) - float(w[4])))


def lightglue_witness(params, ins, adaptive):
    """LightGlue on one pair's inputs ins (CUDA) on the card, through the
    plain twins and in float64 on the host (the witness of how far float32
    rounding carries at these logits). Fixed depth: the scores at depths
    1, 2 and 9; each one's largest error against float64 (card within 4x
    the plain twin's + 1e-6 of the largest score), and the matches at
    depths 2 and 9: card and plain twin may part only in rows whose float64
    decision margin is within twice the measured error; the matched
    mscores within 4x the plain twin's error + 1e-5. Adaptive: the
    decision values (confidences, matchabilities, confident share) of
    every layer the three runs decide over the same masks, card within 4x
    the plain twin's error + 1e-6; card and plain twin may decide
    differently only where the reference's margin (float64's where it
    agreed with both till then, else the plain twin's) is within their
    measured gap; with the same decisions, their matches part only in
    rows as above. Raises AssertionError on a failed gate; returns the
    readings."""
    import torch

    from keypoint_bench_tpu_torch.models.lightglue import (
        filter_matches, lightglue_scores)
    from keypoint_bench_tpu_torch.models.lightglue_adaptive import \
        lightglue_forward_adaptive
    p64 = {k: v.detach().cpu().double() for k, v in params.items()}
    ins64 = [x.cpu().double() if x.is_floating_point() else x.cpu()
             for x in ins]
    v0, v1 = ins64[1], ins64[4]
    live = v0[:, None] & v1[None, :]
    row = {}

    def fail(msg):
        raise AssertionError(f"LightGlue card vs plain twin vs float64: "
                             f"{msg}")

    if not adaptive:
        depth = {}
        for n in (1, 2, 9):
            a = lightglue_scores(params, *ins, n_layers=n).cpu().double()
            with plain_twins():
                b = lightglue_scores(params, *ins, n_layers=n).cpu().double()
            w = lightglue_scores(p64, *ins64, n_layers=n)
            scale = float(w[live].abs().max())
            ec = float((a - w)[live].abs().max())
            ep = float((b - w)[live].abs().max())
            depth[n] = (ec / scale, ep / scale)
            if ec > 4 * ep + 1e-6 * scale:
                fail(f"depth {n}: the card's scores {ec:.4g} from float64, "
                     f"the plain twin's {ep:.4g}")
            if n == 1:
                continue
            mc, mp, m64 = (filter_matches(x, v0, v1, 0.1) for x in (a, b, w))
            n_diff, n_far = parted_rows(mc[0], mp[0], w, v0, v1, max(ec, ep))
            both = mc[2] & mp[2] & m64[2]
            msc = largest((mc[1] - m64[1])[both].abs())
            msp = largest((mp[1] - m64[1])[both].abs())
            row[f"depth{n}"] = {
                "matches": [int(x[2].sum()) for x in (mc, mp, m64)],
                "parted_rows": n_diff, "ms_err": [msc, msp],
                "ms_max": largest(m64[1][m64[2]])}
            if n_far or msc > 4 * msp + 1e-5:
                fail(f"depth {n}: {n_far} of {n_diff} parted rows beyond "
                     f"the error, mscores {msc:.3g} from float64 (plain "
                     f"{msp:.3g})")
        row["depth_err"] = depth
        return row

    runs = {}
    for name, p, x in (("card", params, ins), ("plain", params, ins),
                       ("f64", p64, ins64)):
        st = {}
        with plain_twins() if name == "plain" else contextlib.nullcontext():
            o = lightglue_forward_adaptive(p, *x, stats=st)
        runs[name] = (o, st, adaptive_decisions(st, o[3]))
    (oc, stc, dc), (op, stp, dp), (o64, st64, d64) = (
        runs[n] for n in ("card", "plain", "f64"))
    n = min(len(dc), len(dp), len(d64))
    first = next((i for i in range(n) if not (
        same_decision(dc[i], d64[i]) and same_decision(dp[i], d64[i]))), n)
    errs = []
    for i in range(min(first + 1, n)):
        ec, ep = value_gap(stc, st64, i), value_gap(stp, st64, i)
        errs.append((ec, ep, float(st64["margin"][i])))
        if ec > 4 * ep + 1e-6:
            fail(f"layer {i}: the card's decision values {ec:.4g} from "
                 f"float64, the plain twin's {ep:.4g}")
    split = next((i for i in range(n) if not same_decision(dc[i], dp[i])),
                 None)
    row.update(i_fin=[int(o[3]) for o in (oc, op, o64)],
               matches=[int(o[2].sum()) for o in (oc, op, o64)],
               ms_max=largest(o64[1][o64[2]]),
               decision_err=errs, first_f64_split=first if first < n
               else None, card_plain_split=split)
    if split is not None:
        # the layer's decision must lie within the measured gap
        if split == first and split < len(errs):
            gap, margin = max(errs[split][:2]), errs[split][2]
        else:
            gap = value_gap(stc, stp, split)
            margin = float(stp["margin"][split])
        row["split"] = {"layer": split, "gap": gap, "margin": margin}
        if margin > gap:
            fail(f"card and plain twin decide differently at layer {split} "
                 f"with a margin of {margin:.3g} beyond their gap "
                 f"{gap:.3g}")
        return row
    a0, a1 = stc["masks"]
    if first == n:
        ref, w = st64["scores"], st64["scores"]
        m = a0.cpu()[:, None] & a1.cpu()[None, :]
        ec = float((stc["scores"].cpu().double() - w)[m].abs().max())
        ep = float((stp["scores"].cpu().double() - w)[m].abs().max())
        scale = float(w[m].abs().max())
        if ec > 4 * ep + 1e-6 * scale:
            fail(f"the card's final scores {ec:.4g} from float64, the "
                 f"plain twin's {ep:.4g}")
        err = max(ec, ep)
    else:
        ref = stp["scores"].cpu().double()
        err = float((stc["scores"].cpu().double() - ref).abs().max())
    n_diff, n_far = parted_rows(oc[0], op[0], ref, a0, a1, err)
    row.update(parted_rows=n_diff, score_err=err)
    if n_far:
        fail(f"{n_far} of {n_diff} parted rows beyond the error {err:.3g}")
    return row


def witness_summary(rows, adaptive):
    """The float64 witness's readings of phase 63's pairs, for its JSON
    line: pair 0's errors at depths 1, 2, 9 (card, plain twin), the depth-2
    and depth-9 matches (card, plain twin, float64) or the adaptive layers
    run and matches, and the adaptive decisions' first split from
    float64."""
    if not adaptive:
        return {"depth_err_pair0": rows[0]["depth_err"],
                "matches_depth2": [r["depth2"]["matches"] for r in rows],
                "matches_depth9": [r["depth9"]["matches"] for r in rows],
                "ms_max_depth2": max(r["depth2"]["ms_max"] for r in rows)}
    return {"i_fin": [r["i_fin"] for r in rows],
            "lightglue_matches": [r["matches"] for r in rows],
            "ms_max": max(r["ms_max"] for r in rows),
            "first_f64_split": [r["first_f64_split"] for r in rows],
            "decision_err_max": max(max(e[:2]) for r in rows
                                    for e in r["decision_err"])}


def e_against_f64(args, kwargs):
    """Kernel E and its plain twin on one call's inputs against the float64
    masked softmax: (E's largest error, the plain twin's, max |v|, max
    |logit| over valid keys, E's largest gap to the plain twin). Logits of
    thousands make the f32 softmax sensitive at ulp(logit) (about 1e-3 at
    1e4): both f32 routes part from float64 there."""
    import torch

    from keypoint_bench_tpu_torch.ops import cuda_attention
    from keypoint_bench_tpu_torch.ops.attention import fused_attention
    q, k, v, m = args[:4]
    scale = args[4] if len(args) > 4 else kwargs.get("scale")
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = (q.double() @ k.double().transpose(-1, -2)) * scale
    live = m[..., None, :].expand_as(s)
    ref = torch.softmax(torch.where(live, s, -1e9), -1) @ v.double()
    got = cuda_attention.attention_cuda(*args, **kwargs).double()
    plain = fused_attention(*args, **kwargs).double()
    return (float((got - ref).abs().max()), float((plain - ref).abs().max()),
            float(v.abs().max()), float(s[live].abs().max()),
            float((got - plain).abs().max()))


def convert_demo_phases(dev, card, errs):
    """Phases 62-64: the reference's checkpoints converted on this machine
    (no JAX), DISK + LightGlue MHA through the runner from the converted
    weights, and the demo. The launch counts are reset just before each
    path and read just after. Returns the numbers for the convert_demo
    and kernels JSON lines."""
    import shutil

    import torch
    import torch.nn.functional as F

    from keypoint_bench_tpu_torch import demo
    from keypoint_bench_tpu_torch.datasets import get_dataset
    from keypoint_bench_tpu_torch.datasets.synthetic import \
        SyntheticHomographyDataset
    from keypoint_bench_tpu_torch.models.lightglue import \
        sample_descriptors_lg
    from keypoint_bench_tpu_torch.ops import cuda_attention
    from keypoint_bench_tpu_torch.ops.attention import fused_attention
    from keypoint_bench_tpu_torch.runner import EvalConfig, Evaluator
    from keypoint_bench_tpu_torch.weights import SPECS
    from keypoint_bench_tpu_torch.weights.convert import main as convert
    from keypoint_bench_tpu_torch.weights.upstream import (
        npz_equal, upstream_params, write_upstream_checkpoints)

    out = {}
    t_start = time.perf_counter()
    base = os.path.join(ROOT, "output", "chip_smoke_convert")
    shutil.rmtree(base, ignore_errors=True)
    src, dst = os.path.join(base, "upstream"), os.path.join(base, "npz")
    pointers, absent = ("lightglue_aliked",), ("lightglue_superpoint",)
    with phase(f"the reference's checkpoints converted without JAX: "
               f"{len(SPECS)} SPECS entries, one a git-LFS pointer, one "
               f"absent"):
        t0 = time.perf_counter()
        params = upstream_params([n for n in SPECS if n not in absent])
        write_upstream_checkpoints(src, params, pointers)
        t1 = time.perf_counter()
        converted, skipped = convert(src, dst)
        t2 = time.perf_counter()
        names = [n for n, _ in converted]
        unequal = [n for n in names if not npz_equal(
            os.path.join(dst, f"{n}.npz"), params[n])]
        jax_mods = sorted(m for m in sys.modules if m.split(".")[0] in (
            "jax", "jaxlib", "keypoint_bench_tpu"))
        out["convert"] = {
            "converted": names, "tensors": sum(n for _, n in converted),
            "skipped": skipped, "write_s": t1 - t0, "convert_s": t2 - t1,
            "npz_bytes": sum(os.path.getsize(os.path.join(dst, f))
                             for f in os.listdir(dst))}
        log(f"  converted {len(names)} checkpoints "
            f"({out['convert']['tensors']} tensors, "
            f"{out['convert']['npz_bytes']} npz bytes) in "
            f"{t2 - t1:.3f} s (writing them {t1 - t0:.3f} s); skipped "
            f"{skipped}; npz unequal to their source: {unequal}; JAX "
            f"modules loaded: {jax_mods}")
        if (skipped != [n for n in SPECS if n in pointers + absent]
                or names != [n for n in SPECS if n not in skipped]
                or unequal or jax_mods):
            raise AssertionError("the converter's output differs")

    tree = hpatches_tree(os.path.join(base, "hpatches"),
                         sizes=((SIZE, SIZE),) * 3, n_images=DISK_LG_IMAGES,
                         seed=63)
    n_pairs = 3 * (DISK_LG_IMAGES - 1)
    out["disk_lightglue"] = {}

    def pair_outputs(ev, item):
        """(k0, v0, m1, ok, E launches, E calls, LightGlue's inputs) of one
        pair through the runner's maps and matcher."""
        img0, _, _, d0, k0, v0, _, d1, k1, v1 = ev._pair_maps(item)
        _, _, va = ev._warp(k0, v0, item["warp01_params"])
        _, _, vb = ev._warp(k1, v1, item["warp10_params"])
        w, h = img0.shape[1], img0.shape[0]
        reset_launches()
        with recording(cuda_attention, "attention_cuda") as calls:
            _, m1, ok = ev._match(k0, va, k1, vb, d0, d1, w, h)
            torch.cuda.synchronize()
        n_e = read_launches()["attention"]
        p0, p1 = k0[:, :2] * (w - 1.0), k1[:, :2] * (w - 1.0)
        ins = (p0, va, sample_descriptors_lg(p0, d0, 1), p1, vb,
               sample_descriptors_lg(p1, d1, 1))
        return k0, v0, m1, ok, n_e, list(calls), ins

    for mode in ("fixed", "adaptive"):
        adaptive = mode == "adaptive"
        with phase(f"MHA runner: DISK + light_glue ({mode}) from the "
                   f"converted weights, {n_pairs} HPatches pairs at "
                   f"{SIZE}^2, top_k {K}, card vs plain twin vs float64"):
            cfg = file_config("mha_hpatches", os.path.join(
                base, f"mha_{mode}"), root=tree, image_size=SIZE)
            cfg["extractor_params"] = {**cfg["extractor_params"], "top_k": K}
            cfg.update(model_type="DISK", weights_dir=dst, matcher_params={
                "type": "light_glue", "light_glue_params": {
                    "adaptive": adaptive, "allow_fallback": False}})
            ev = Evaluator(EvalConfig(**cfg), DEVICE)
            proj = tuple(ev.lightglue_params["input_proj.weight"].shape)
            if ev.matcher_fallback is not None or proj != (256, 128):
                raise AssertionError(f"the runner did not load the disk "
                                     f"LightGlue: {ev.matcher_fallback}, "
                                     f"input_proj {proj}")
            reset_launches()
            res = ev.run()
            torch.cuda.synchronize()
            got = read_launches()
            with plain_twins():
                res_p = Evaluator(EvalConfig(**cfg), DEVICE).run()
            t0 = time.perf_counter()        # a warm run, for its time
            ev.run()
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            ds = get_dataset(cfg["data_params"])
            rows, e_err, first_calls = [], 0.0, None
            worst = (0.0,)
            t_wit = 0.0
            for i in range(len(ds)):
                c = pair_outputs(ev, ds[i])
                with plain_twins():
                    pl = pair_outputs(ev, ds[i])
                for j, (a, kw) in enumerate(c[5]):
                    e, p, vmax, smax, gap_plain = e_against_f64(a, kw)
                    e_err = max(e_err, gap_plain)
                    worst = max(worst, (e / (4 * p + 1e-5 * max(1.0, vmax)),
                                        i, j, e, p, vmax, smax))
                first_calls = first_calls or c[5]
                if not (torch.equal(c[0], pl[0]) and torch.equal(c[1], pl[1])):
                    raise AssertionError(f"DISK's keypoints on pair {i} "
                                         f"differ from the plain twin's")
                same = (torch.equal(c[3], pl[3])
                        and torch.equal(c[2][c[3]], pl[2][pl[3]]))
                t1 = time.perf_counter()
                wit = lightglue_witness(ev.lightglue_params, c[6], adaptive)
                t_wit += time.perf_counter() - t1
                rows.append({"valid": [int(c[6][1].sum()),
                                       int(c[6][4].sum())],
                             "launches": c[4],
                             "runner_matches": int(c[3].sum()),
                             "plain_equal": same, **wit})
                if c[4] <= 0 or c[4] > 18 or (not adaptive and c[4] != 18):
                    raise AssertionError(f"kernel E launched {c[4]} times "
                                         f"on pair {i} ({mode})")
            _, wi, wj, we, wp, wv, ws = worst
            log(f"  kernel E against the float64 softmax on every call: "
                f"the largest share of its gate, {worst[0]:.3g}, on pair "
                f"{wi}'s call {wj}: E {we:.3g}, the plain twin {wp:.3g}, "
                f"max |v| {wv:.4g}, max |logit| {ws:.6g}; E against the "
                f"plain twin within {e_err:.3g}")
            if worst[0] > 1.0:
                raise AssertionError("kernel E is further from the float64 "
                                     "softmax than 4x the plain twin + "
                                     "1e-5 max(1, |v|)")
            for i, r in enumerate(rows):
                wit = {k: v for k, v in r.items() if k not in (
                    "valid", "launches", "runner_matches", "plain_equal")}
                log(f"  pair {i}: valid {r['valid']}, E launches "
                    f"{r['launches']}, the runner's matches "
                    f"{r['runner_matches']} "
                    f"(equal to the plain twin's: {r['plain_equal']}); "
                    f"witness {json.dumps(wit, default=float)}")
            if adaptive:
                parted = [i for i, r in enumerate(rows)
                          if r["card_plain_split"] is not None
                          or r["parted_rows"]]
            else:
                parted = [i for i, r in enumerate(rows)
                          if r["depth9"]["parted_rows"]]
                if not sum(r["depth2"]["matches"][0] for r in rows):
                    raise AssertionError("no match at depth 2 to hold")
            mha = [res[f"MHA@{t}"] for t in (3, 5, 7)]
            log(f"  MHA@3/5/7 {mha} (plain "
                f"{[res_p[f'MHA@{t}'] for t in (3, 5, 7)]}); the run's "
                f"launches {got}; a warm run {run_s:.3f} s; pairs whose "
                f"LightGlue parted from the plain twin within the float32 "
                f"error {parted}; the float64 witness {t_wit:.1f} s")
            kept = [i for i, r in enumerate(rows) if r["plain_equal"]]
            if (any(res["per_pair"][i] != res_p["per_pair"][i] for i in kept)
                    or any(not rows[i]["plain_equal"] for i in range(
                        len(rows)) if i not in parted)
                    or "matcher_fallback" in res or got["attention"] <= 0
                    or got["nms"] != 2 * n_pairs):
                raise AssertionError(f"the DISK + LightGlue runner ({mode}) "
                                     f"differs from its plain twin or "
                                     f"missed a kernel: {got}")
            item = ds[0]
            img0, _, _, d0, k0, v0, _, d1, k1, v1 = ev._pair_maps(item)
            match_ms = host_ms(lambda: ev._match(k0, v0, k1, v1, d0, d1,
                                                 SIZE, SIZE))
            r = {"MHA": mha, "launches": got["attention"],
                 "launches_per_pair": [r["launches"] for r in rows],
                 "matches_per_pair": [r["runner_matches"] for r in rows],
                 "parted_pairs": parted, **witness_summary(rows, adaptive),
                 "e_err_plain": e_err, "e_gate_share": worst[0],
                 "e_err_f64": we, "plain_err_f64": wp, "max_logit": ws,
                 "ms_pair_runner": run_s * 1e3 / n_pairs,
                 "ms_pair_lightglue": match_ms}
            calls = first_calls
            n = len(calls)
            masks = [torch.where(a[3], 0.0, -1e9)[..., None, :]
                     for a, _ in calls]
            e_ms, lib_ms, turns = in_turns(
                lambda: [cuda_attention.attention_cuda(*a, **kw)
                         for a, kw in calls],
                lambda: [F.scaled_dot_product_attention(
                    a[0], a[1], a[2], attn_mask=m, scale=a[4])
                    for (a, _), m in zip(calls, masks)])
            plain_ms = cuda_ms(lambda: [fused_attention(*a, **kw)
                                        for a, kw in calls], iters=3)
            bound, by = adaptive_attention_bound(calls)
            r.update(shape=list(calls[0][0][0].shape), calls=n,
                     e_ms_call=e_ms / n, sdpa_ms_call=lib_ms / n,
                     plain_ms_call=plain_ms / n, bound_ms_call=bound / n,
                     bound_by=by)
            log(f"  a pair: runner {r['ms_pair_runner']:.3f} ms (warm, the "
                f"PPM loads included), LightGlue match {match_ms:.3f} ms; "
                f"kernel E on pair 0's {n} calls ({r['shape']}, the valid "
                f"counts of DISK's detections): {e_ms / n:.4f} ms a call "
                f"(events over back-to-back calls, which the kernel's "
                f"time paces), sdpa {lib_ms / n:.4f}, plain "
                f"{plain_ms / n:.4f}, bound {bound / n:.4f} ({by}); in "
                f"turns kernel, sdpa, sdpa, kernel "
                f"{[round(t / n, 4) for t in turns]} on {card}")
            out["disk_lightglue"][mode] = r

    with phase(f"the demo on the card: Alike at {SIZE}^2 (A, D, RANSAC-H) "
               f"against its plain twin"):
        douts = [os.path.join(base, d) for d in ("demo", "demo_plain")]
        reset_launches()
        res = demo.run("Alike", douts[0], SIZE, DEVICE)
        torch.cuda.synchronize()
        got = read_launches()
        with plain_twins():
            res_p = demo.run("Alike", douts[1], SIZE, DEVICE)
        same_png = all(
            open(os.path.join(douts[0], f), "rb").read()
            == open(os.path.join(douts[1], f), "rb").read()
            for f in res["files"])
        gaps = [demo.corner_gap(r["H"], r["gt"], SIZE)
                for r in (res, res_p)]
        quiet = io.StringIO()
        with contextlib.redirect_stdout(quiet):
            demo_ms = host_ms(lambda: demo.run("Alike", douts[0], SIZE,
                                               DEVICE), iters=3)
        sample = SyntheticHomographyDataset(1, SIZE)[0]
        im0, im1 = (torch.as_tensor(sample[k], device=dev)
                    for k in ("image0", "image1"))
        model = demo.load_model("Alike", dev)
        pipe_ms = cuda_ms(lambda: demo.pipeline(model, im0, im1))
        out["demo"] = {"keypoints": list(res["keypoints"]),
                       "matches": res["matches"],
                       "keypoints_plain": list(res_p["keypoints"]),
                       "matches_plain": res_p["matches"],
                       "png_equal": same_png, "corner_gap_px": gaps,
                       "launches": got, "ms": demo_ms,
                       "ms_pipeline": pipe_ms}
        log(f"  keypoints {res['keypoints']} matches {res['matches']} "
            f"(plain {res_p['keypoints']} {res_p['matches']}); PNGs equal "
            f"{same_png}; H's corners within {gaps[0]:.3f} px of the "
            f"ground truth's (plain {gaps[1]:.3f}); launches {got}; the "
            f"demo {demo_ms:.3f} ms (PNGs included), forwards + detection "
            f"+ brute force {pipe_ms:.3f} ms on {card}")
        if not (res["keypoints"] == res_p["keypoints"]
                and res["matches"] == res_p["matches"] and same_png
                and max(gaps) < 3.0 and got["nms"] == 2
                and got["nn_match"] > 0):
            raise AssertionError("the demo differs from its plain twin or "
                                 "missed a kernel")
    out["seconds"] = time.perf_counter() - t_start
    return out


def _with_group(fn):
    """fn(mesh) on the one-rank NCCL group."""
    with one_rank_group() as mesh:
        return fn(mesh)


# The BatchNorm epilogue's timed forms, f32 as the cells run them:
# (name, shape, affine, residual, conv bias)
BN_CASES = [("alike_t.block1", (32, 8, 512, 512), True, False, False),
            ("alike_t.block2", (32, 16, 256, 256), True, True, False),
            ("alike_t.block4", (32, 64, 16, 16), True, True, False),
            ("r2d2", (4, 128, 512, 512), False, False, True)]
L2_BYTES = 50e6


def bn_bound(x, residual, out, n_stats):
    """(ms, bound_by) of one epilogue: x (and the residual) read once, y
    written once, and `n_stats` [C] f32 vectors read, at PEAK_BYTES."""
    n = sum(t.numel() * t.element_size() for t in (x, residual, out)
            if t is not None) + 4 * n_stats * x.shape[1]
    return n / PEAK_BYTES * 1e3, "bytes"


def bn_epilogue_phase(dev, errs, model, imgs):
    """The BatchNorm epilogue (csrc/bn_epilogue.cu): every call of an
    ALIKE-t `feats` on `imgs` and of an R2D2 forward on four of them
    against `bn_chain` on the same inputs, bit for bit; then, at the
    cells' shapes, the kernel and the chain in turns (CUDA events over
    back-to-back calls that cycle over copies of the inputs, more than the
    L2 holds), the kernel's own device time from the profiler and its
    byte bound."""
    import torch
    from keypoint_bench_tpu_torch.models import get_model
    from keypoint_bench_tpu_torch.models.common import bn_chain
    from keypoint_bench_tpu_torch.ops import cuda_bn
    from keypoint_bench_tpu_torch.weights import load_params
    out = {"launches_per_forward": {}, "shapes": []}
    with phase("BatchNorm epilogue vs plain bn_chain: the forwards' calls, "
               "then the cells' shapes in turns"):
        r2d2 = get_model("r2d2")(load_params("r2d2", device=dev)).eval()
        forwards = {"alike_t.feats": lambda: model.feats(imgs),
                    "r2d2.forward": lambda: r2d2(imgs[:4])}
        for name, fwd in forwards.items():
            before = cuda_bn.KERNEL.launches
            with torch.inference_mode(), \
                    recording(cuda_bn, "bn_epilogue") as calls:
                fwd()
            n = cuda_bn.KERNEL.launches - before
            forms = []
            for args, kw in calls:
                with torch.inference_mode():
                    same = bits_equal(cuda_bn.bn_epilogue(*args, **kw),
                                      bn_chain(*args, **kw))
                if not same:
                    raise AssertionError(f"the epilogue differs from "
                                         f"bn_chain in {name}")
                x, gamma, _, _, _, _, relu, res, bias = args
                forms.append(f"{list(x.shape)} {str(x.dtype)[6:]}"
                             + " affine" * (gamma is not None)
                             + " bias" * (bias is not None)
                             + " residual" * (res is not None)
                             + " relu" * bool(relu))
            log(f"  {name}: {n} launches, each equal to bn_chain bit for "
                f"bit: " + "; ".join(forms))
            if n != 8 or len(calls) != 8:
                raise AssertionError(f"{name}: 8 epilogues a forward, got "
                                     f"{n} launches of {len(calls)} calls")
            out["launches_per_forward"][name] = n
            del calls
        del r2d2
        g = torch.Generator(device=dev).manual_seed(0)
        for name, shape, affine, res, has_bias in BN_CASES:
            c = shape[1]
            per = 4 * torch.Size(shape).numel() * (2 + res)
            copies = max(1, -(-int(2 * L2_BYTES) // per))
            xs = [torch.randn(shape, generator=g, device=dev)
                  for _ in range(copies)]
            rs = [torch.randn(shape, generator=g, device=dev) if res
                  else None for _ in range(copies)]

            def vec(on=True):
                return torch.randn(c, generator=g, device=dev) if on else None
            stats = (vec(affine), vec(affine), vec(),
                     torch.rand(c, generator=g, device=dev) + 0.5)
            bias = vec(has_bias)
            turn = [0]

            def call(fn):
                def run():
                    i = turn[0] % copies
                    turn[0] += 1
                    return fn(xs[i], *stats, 1e-5, True, rs[i], bias)
                return run
            kernel, chain = call(cuda_bn.bn_epilogue), call(bn_chain)
            with torch.inference_mode():
                y = kernel()
                turn[0] = 0
                same = bits_equal(y, chain())
            if not same:
                raise AssertionError(f"the epilogue differs from bn_chain "
                                     f"at {name}")
            k_ms, c_ms, four = in_turns(kernel, chain, iters=50,
                                        other_iters=50)
            _, _, kernels = profile_step(lambda: [kernel()
                                                  for _ in range(10)],
                                         top=20)
            own = sum(t for k, t in kernels if "bn_epilogue_kernel" in k) / 10
            c_busy, _, _ = profile_step(lambda: [chain() for _ in range(10)])
            bound, by = bn_bound(xs[0], rs[0], y, 2 + 2 * affine + has_bias)
            row = {"case": name, "shape": list(shape), "affine": affine,
                   "residual": res, "bias": has_bias, "copies": copies,
                   "ms": k_ms, "plain_ms": c_ms, "ms_in_turns": four,
                   "device_ms": own, "plain_device_ms": c_busy / 10,
                   "bound_ms": bound, "bound_by": by}
            out["shapes"].append(row)
            log(f"  {name} {list(shape)}: kernel {k_ms:.4f} ms (events; own "
                f"device time {own:.4f}), chain {c_ms:.4f} ms (device "
                f"{c_busy / 10:.4f}); in turns kernel, chain, chain, kernel: "
                + ", ".join(f"{t:.4f}" for t in four)
                + f"; bound {bound:.4f} ms ({by}); bound / own device time "
                f"{bound / own:.3f}")
            del xs, rs, y
            torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "keypoint_bench_tpu_torch")):
        print("chip_smoke: keypoint_bench_tpu_torch/ is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    from keypoint_bench_tpu_torch.datasets import get_dataset
    from keypoint_bench_tpu_torch.models import get_model
    from keypoint_bench_tpu_torch.datasets.synthetic import \
        SyntheticSequenceDataset
    from keypoint_bench_tpu_torch.ops import (_build, cuda_attention,
                                              cuda_lk, cuda_match, cuda_nms,
                                              cuda_sample)
    from keypoint_bench_tpu_torch.ops.detect import (DetectParams,
                                                     detection_batch,
                                                     detection_batch_fused,
                                                     fast_nms,
                                                     fast_nms_rounds,
                                                     fused_topk, peel_topk,
                                                     remove_border)
    from keypoint_bench_tpu_torch.ops.lk import (LKParams, _avg_pool_img,
                                                 _lk_level, draw_angles,
                                                 optical_flow_batch_from_angles)
    from keypoint_bench_tpu_torch.ops.matching import (mutual_nn_match,
                                                       nn_dists, penalized)
    from keypoint_bench_tpu_torch.ops.sparse_desc import (
        alike_sparse_descriptors_cm_batch_yorder, row_tap_keys,
        sample_branches)
    import torch.nn.functional as F

    from keypoint_bench_tpu_torch.models.lightglue import (
        lightglue_scores, sample_descriptors_lg)
    from keypoint_bench_tpu_torch.ops.attention import fused_attention
    from keypoint_bench_tpu_torch.ops.grid_sample import sample_at_points
    from keypoint_bench_tpu_torch.pipeline import (covisible, extract,
                                                   extract_match,
                                                   lk_fundamental_step,
                                                   match_pairs,
                                                   superpoint_detect,
                                                   superpoint_mha_step)
    from keypoint_bench_tpu_torch.tasks.fundamental import \
        fundamental_metrics
    from keypoint_bench_tpu_torch.runner import EvalConfig, Evaluator
    from keypoint_bench_tpu_torch.tasks.mha import mha_pair
    from keypoint_bench_tpu_torch.weights import (load_golden_params,
                                                  load_params,
                                                  stage_golden_weights)

    dev = torch.device(DEVICE)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}")
    torch.manual_seed(0)

    with phase("build kernels (nvcc, parallel)"):
        t0 = time.perf_counter()
        with ThreadPoolExecutor() as pool:
            info = {n: pool.submit(ptxas_info, n)
                    for n in ("sample", "match", "attention", "lk", "peel")}
            list(pool.map(_build.build,
                          ["nms", "sample", "match", "attention", "lk",
                           "peel", "bn_epilogue"]))
            ptxas = {n: f.result() for n, f in info.items()}
        log(f"build: {time.perf_counter() - t0:.1f} s")
        for name, lines in ptxas.items():
            for ln in lines:
                log(f"  ptxas {name}.cu: {ln}")
        tiles = [ctypes.c_int() for _ in range(3)]
        ctypes.CDLL(_build.build("attention")).kbt_attention_tiles(
            *map(ctypes.byref, tiles))
        bq, bk, att_smem = (t.value for t in tiles)
        log(f"  kernel E tiles: {bq} query rows x {bk} keys, {att_smem} bytes "
            f"of dynamic shared memory a block; kernel F: "
            f"{cuda_lk.smem_bytes(21, 3)} bytes a block at win 21, C 3, "
            f"{cuda_lk.block_threads(21, 3)} threads")
        if (bq, bk) != (cuda_attention.BQ, cuda_attention.BK):
            raise AssertionError("ops/cuda_attention.py BQ, BK differ from "
                                 "the built kernel's tiles")

    params = load_params("Alike", device=dev)
    model = get_model("Alike")(params).eval()
    dp = DetectParams(nms_dist=6, border_dist=8, top_k=K)
    errs = {"nms": 0.0, "sample": 0.0, "nn_match": 0.0, "attention": 0.0,
            "lk": 0.0, "peel": 0.0, "bn_epilogue": 0.0}
    sp_params = load_golden_params("SuperPoint", dev)
    sp_model = get_model("SuperPoint")(sp_params).eval()
    lg_params = load_golden_params("lightglue", dev)

    with phase("forward: ALIKE-t, SuperPoint and XFeat, card vs CPU at "
               "128^2"):
        img = torch.from_numpy(np.random.default_rng(0).random(
            (1, 128, 128, 3), np.float32))
        for name, m_gpu, m_cpu in (
                ("Alike", model, get_model("Alike")(load_params("Alike"))),
                ("SuperPoint", sp_model, get_model("SuperPoint")(
                    load_golden_params("SuperPoint"))),
                ("XFeat", get_model("XFeat")(load_golden_params("XFeat",
                                                                dev)),
                 get_model("XFeat")(load_golden_params("XFeat")))):
            with torch.inference_mode():
                s_gpu, d_gpu = m_gpu(img.to(dev))
                s_cpu, d_cpu = m_cpu(img)
            err = max(float((s_gpu.cpu() - s_cpu).abs().max()),
                      float((d_gpu.cpu() - d_cpu).abs().max()))
            log(f"  {name} forward max abs err {err:.3g}")
            if not err <= 1e-4:
                raise AssertionError(f"{name} forward card vs CPU: {err}")

    with phase("data: 16 synthetic homography pairs at 512^2"):
        ds = get_dataset({"type": "synthetic_homography",
                          "num_pairs": PAIRS, "image_size": SIZE})
        items = [ds[i] for i in range(PAIRS)]
        imgs0 = torch.from_numpy(np.stack([s["image0"] for s in items])).to(dev)
        imgs1 = torch.from_numpy(np.stack([s["image1"] for s in items])).to(dev)
        with torch.inference_mode():
            score0, feats0 = model.feats(imgs0)
        maps0 = score0[..., 0].contiguous()

    with phase("kernel A (NMS fixpoint) vs plain fast_nms"):
        blocks, per_sm, threads, smem = cuda_nms.nms_grid(6)
        tiles = PAIRS * (SIZE // 32) ** 2
        log(f"  grid at d=6: {blocks} blocks resident ({per_sm} per SM) of "
            f"{threads} threads, {smem} bytes of dynamic shared memory a "
            f"block; [16,512,512] launches min(blocks, {tiles} tiles) = "
            f"{min(blocks, tiles)}")
        bf = maps0[:1].to(torch.bfloat16)
        cases = [("score maps x8", maps0[:8], 6), ("bf16 ties", bf, 6),
                 ("signed", maps0[-2:] - 0.5, 6),
                 ("score d=2", maps0[:2], 2), ("score d=4", maps0[:2], 4)]
        for name, maps, d in cases:
            stats = torch.zeros(maps.shape[0] + 62, dtype=torch.int32,
                                device=dev)
            before = cuda_nms.KERNEL.launches
            got = cuda_nms.nms_cuda(maps, d, 30, stats=stats)
            n_launch = cuda_nms.KERNEL.launches - before
            want, want_rounds = fast_nms_rounds(maps, d, 30)
            diff = float((got.float() - want.float()).abs().max())
            errs["nms"] = max(errs["nms"], diff)
            ran = stats[:maps.shape[0]]
            log(f"  {name}: equal={torch.equal(got, want)} "
                f"max_abs_err={diff}; launches {n_launch}; rounds per map "
                f"{ran.tolist()} (plain {want_rounds.tolist()})")
            if not (torch.equal(got, want) and n_launch == 1
                    and torch.equal(ran, want_rounds)):
                raise AssertionError(f"kernel A differs on {name}")
        stats = torch.zeros(PAIRS + 62, dtype=torch.int32, device=dev)
        before = cuda_nms.KERNEL.launches
        cuda_nms.nms_cuda(maps0, 6, 30, stats=stats)
        nms_per_call = cuda_nms.KERNEL.launches - before
        _, rounds = fast_nms_rounds(maps0, 6, 30)
        n_r = int(rounds.max()) + 1
        k_mask = stats[PAIRS:PAIRS + n_r].tolist()
        k_supp = stats[PAIRS + 31:PAIRS + 31 + n_r].tolist()
        mask_tiles, supp_tiles, mask_px, supp_px = nms_tile_work(maps0, 6)
        log(f"  [16,512,512] d=6: rounds per map {rounds.tolist()} (kernel "
            f"{stats[:PAIRS].tolist()}); tiles recomputed per round, summed "
            f"over the batch: mask {k_mask}, suppression {k_supp[1:]} "
            f"(the plain run's changed neighbourhoods: {mask_tiles}, "
            f"{supp_tiles[1:]})")
        if not (torch.equal(stats[:PAIRS], rounds) and k_mask == mask_tiles
                and k_supp == supp_tiles and nms_per_call == 1):
            raise AssertionError("kernel A's rounds, recomputed tiles or "
                                 "launches differ from the plain run's")
        nms_ms = cuda_ms(lambda: cuda_nms.nms_cuda(maps0, 6, 30))
        # the rounds a call may run: 0 is round 0 alone; the most any map
        # needs runs all the work of max_iter 30, with nothing after it
        split = {it: cuda_ms(lambda: cuda_nms.nms_cuda(maps0, 6, it))
                 for it in (0, 1, n_r - 1)}
        nms_plain_ms = cuda_ms(lambda: fast_nms(maps0, 6, 30), iters=3,
                               warmup=1)
        nms_full_ms, nms_full_by = nms_bound(maps0, rounds)
        nms_bound_ms, nms_bound_by = nms_change_bound(maps0, mask_px,
                                                      supp_px)
        log(f"  [16,512,512] d=6: kernel {nms_ms:.4f} ms ({nms_per_call} "
            f"launch), by max_iter "
            + ", ".join(f"{it}: {ms:.4f}" for it, ms in split.items())
            + f" ms; plain {nms_plain_ms:.4f} ms, bound {nms_bound_ms:.4f} "
            f"ms ({nms_bound_by}; pixels within d of a change: {mask_px} "
            f"mask, {supp_px} suppression), full-round bound "
            f"{nms_full_ms:.4f} ms ({nms_full_by})")

    with phase("kernel B (sparse sampler) vs plain sampler"):
        with torch.inference_mode():
            kpts0, valid0 = detection_batch(score0, dp)
        px = (kpts0[..., 0] * (SIZE - 1.0)).contiguous()
        py = (kpts0[..., 1] * (SIZE - 1.0)).contiguous()
        order = torch.sort(row_tap_keys(kpts0, SIZE), dim=1, stable=True)[1]
        pxs, pys = px.gather(1, order), py.gather(1, order)
        for name, (x, y) in (("original order", (px, py)),
                             ("y-sorted order", (pxs, pys))):
            got = cuda_sample.sample_cuda(feats0, x, y, SIZE, SIZE)
            want = sample_branches(feats0, x, y, SIZE, SIZE)
            diff = float((got - want).abs().max())
            errs["sample"] = max(errs["sample"], diff)
            log(f"  {name}: max_abs_err={diff:.3g}")
            if not diff <= 1e-5:
                raise AssertionError(f"kernel B differs ({name}): {diff}")
        with torch.inference_mode():
            d_k, k_k, v_k = alike_sparse_descriptors_cm_batch_yorder(
                params, feats0, kpts0, valid0, SIZE, SIZE)
            with plain_twins():
                d_p, k_p, v_p = alike_sparse_descriptors_cm_batch_yorder(
                    params, feats0, kpts0, valid0, SIZE, SIZE)
        diff = float((d_k - d_p).abs().max())
        errs["sample"] = max(errs["sample"], diff)
        log(f"  yorder descriptors: max_abs_err={diff:.3g}")
        if not (diff <= 1e-5 and torch.equal(k_k, k_p)
                and torch.equal(v_k, v_p)):
            raise AssertionError(f"yorder kernel vs plain: {diff}")
        # branches of 3 and 2 rows (a 96^2 or 64^2 image's last branch):
        # the plain twin resizes them densely, the kernel takes its taps
        gen = torch.Generator(device=dev).manual_seed(1)
        for lo in (3, 2):
            sz = 32 * lo
            tiny = tuple(torch.rand((2, 16, sz // r, sz // r), device=dev,
                                    generator=gen) for r in (1, 2, 8, 32))
            tx, ty = (torch.rand((2, 300), device=dev, generator=gen)
                      * (sz - 1) for _ in range(2))
            diff = float((cuda_sample.sample_cuda(tiny, tx, ty, sz, sz)
                          - sample_branches(tiny, tx, ty, sz, sz)).abs().max())
            errs["sample"] = max(errs["sample"], diff)
            log(f"  {sz}^2 branches (last {lo}x{lo}): max_abs_err={diff:.3g}")
            if not diff <= 1e-5:
                raise AssertionError(f"kernel B differs at {sz}^2: {diff}")
        samp_ms = cuda_ms(lambda: cuda_sample.sample_cuda(
            feats0, pxs, pys, SIZE, SIZE))
        samp_plain_ms = cuda_ms(lambda: sample_branches(
            feats0, pxs, pys, SIZE, SIZE), iters=3, warmup=1)
        samp_bound_ms, samp_bound_by = sample_bound(feats0, pxs, pys, SIZE,
                                                    SIZE)
        samp_sector_ms, samp_sector_by, samp_sector_bytes = \
            sample_sector_bound(feats0, pxs, pys, SIZE, SIZE)
        samp_orig_ms = cuda_ms(lambda: cuda_sample.sample_cuda(
            feats0, px, py, SIZE, SIZE))
        log(f"  [16 maps, K={K}]: kernel {samp_ms:.4f} ms y-sorted, "
            f"{samp_orig_ms:.4f} ms original order (CUDA events, "
            f"back-to-back wrapper calls; device time in the next phase), "
            f"plain {samp_plain_ms:.4f} ms, bound {samp_bound_ms:.4f} ms "
            f"({samp_bound_by}; distinct values), sector bound "
            f"{samp_sector_ms:.4f} ms ({samp_sector_by}; "
            f"{samp_sector_bytes} bytes of 32-byte feature sectors)")

    with phase("main path: extract_match, 16 pairs at 512^2"):
        reset_launches()
        n, k0, m1 = extract_match(model, params, imgs0, imgs1, dp, 5.0,
                                 device=DEVICE)
        torch.cuda.synchronize()
        got = read_launches()
        log(f"  launches in one extract_match run: {got}")
        launches = {k: got[k] for k in ("nms", "sample", "bn_epilogue")}
        if min(got["nms"], got["sample"], got["nn_match"]) <= 0:
            raise AssertionError(f"a kernel was not launched: {got}")
        if got["nms"] != 2:
            raise AssertionError(f"kernel A: one launch per detection "
                                 f"batch, 2 a step; got {got['nms']}")
        if got["bn_epilogue"] != 16:
            raise AssertionError(f"the BatchNorm epilogue: one launch a "
                                 f"BatchNorm, 8 a feats, 16 a step; got "
                                 f"{got['bn_epilogue']}")
        with torch.inference_mode():
            ext_k = [extract(model, params, im, dp) for im in (imgs0, imgs1)]
            with plain_twins():
                ext_p = [extract(model, params, im, dp)
                         for im in (imgs0, imgs1)]
                n_p, k0_p, m1_p = extract_match(model, params, imgs0, imgs1,
                                                dp, 5.0, device=DEVICE)
        for (dk, kk, vk), (dp_, kp, vp) in zip(ext_k, ext_p):
            if not (torch.equal(kk, kp) and torch.equal(vk, vp)):
                raise AssertionError("keypoints / masks differ from plain")
        n_valid = int(sum(e[2].sum() for e in ext_k))
        log(f"  matches kernel {int(n)} plain {int(n_p)}; valid keypoints "
            f"{n_valid}; k0 equal {torch.equal(k0, k0_p)}")
        if not torch.equal(k0, k0_p):
            raise AssertionError("k0 differs from the plain-twin pipeline")
        if abs(int(n) - int(n_p)) > 0.005 * n_valid / 2 or int(n) <= 0:
            raise AssertionError(f"match count {int(n)} vs plain {int(n_p)}")
        if not (torch.isfinite(k0).all() and torch.isfinite(m1).all()
                and k0.shape == m1.shape == (PAIRS, K, 3)):
            raise AssertionError("main-path outputs malformed")

        def step():
            return extract_match(model, params, imgs0, imgs1, dp, 5.0,
                                 device=DEVICE)

        windows = timed_windows(step)
        dt = statistics.median(windows)
        fps_all = [2 * PAIRS / w for w in windows]
        log(f"  extract_match: median {dt * 1e3:.3f} ms per 16-pair batch, "
            f"{2 * PAIRS / dt:.2f} frames/s (min {min(fps_all):.2f}, max "
            f"{max(fps_all):.2f}) on {card}")
        with torch.inference_mode():
            st = {"forward (feats, 16 images)":
                  cuda_ms(lambda: model.feats(imgs0), iters=5),
                  "detection_batch (16 maps)":
                  cuda_ms(lambda: detection_batch(score0, dp), iters=5),
                  "yorder descriptors (16 maps)":
                  cuda_ms(lambda: alike_sparse_descriptors_cm_batch_yorder(
                      params, feats0, kpts0, valid0, SIZE, SIZE), iters=5),
                  "mutual_nn_match (16 pairs, kernel D)":
                  cuda_ms(lambda: mutual_nn_match(
                      ext_k[0][0], ext_k[1][0], ext_k[0][2], ext_k[1][2],
                      5.0), iters=5)}
        for name, ms in st.items():
            log(f"  stage {name}: {ms:.4f} ms")
        with torch.inference_mode():
            busy, window, _ = profile_step(lambda: mutual_nn_match(
                ext_k[0][0], ext_k[1][0], ext_k[0][2], ext_k[1][2], 5.0))
        log(f"  stage mutual_nn_match under the profiler: device busy "
            f"{busy:.4f} ms of a {window:.4f} ms window")
        # kernel B's device time of a call (after the timed windows: a
        # process that has profiled once pays more per launch)
        samp_dev = {}
        for name, (x, y) in (("y-sorted", (pxs, pys)),
                             ("original", (px, py))):
            busy, _, _ = profile_step(lambda: [cuda_sample.sample_cuda(
                feats0, x, y, SIZE, SIZE) for _ in range(10)])
            samp_dev[name] = busy / 10
        samp_dev_ms = samp_dev["y-sorted"]
        log(f"  kernel B device time a call: {samp_dev_ms:.4f} ms y-sorted, "
            f"{samp_dev['original']:.4f} ms original order (events "
            f"{samp_ms:.4f} / {samp_orig_ms:.4f}); sector bound "
            f"{samp_sector_ms:.4f} ms, bound {samp_bound_ms:.4f} ms; "
            f"sector bound / device time {samp_sector_ms / samp_dev_ms:.3f}")

    bn = bn_epilogue_phase(dev, errs, model, imgs0)

    with phase("repeatability: synthetic, 4 pairs at 512^2"):
        cfg = EvalConfig.from_yaml(os.path.join(
            ROOT, "configs", "repeatability_synthetic.yaml"))
        cfg.output_dir = os.path.join(ROOT, "output", "chip_smoke_rep")
        rep = Evaluator(cfg, DEVICE).run()
        with plain_twins():
            rep_p = Evaluator(cfg, DEVICE).run()
        log(f"  repeatability {rep['repeatability']} (plain "
            f"{rep_p['repeatability']}), rep_mean_err {rep['rep_mean_err']}")
        if not (0.0 < rep["repeatability"] <= 1.0
                and rep["per_pair_repeatability"]
                == rep_p["per_pair_repeatability"]):
            raise AssertionError("repeatability out of range or != plain")

    Hs = torch.from_numpy(np.stack(
        [s["warp01_params"]["homography_matrix"] for s in items])).to(dev)
    Hinvs = torch.from_numpy(np.stack(
        [s["warp10_params"]["homography_matrix"] for s in items])).to(dev)
    with torch.inference_mode():
        sk0, sv0, sdm0 = superpoint_detect(sp_model, imgs0, dp)
        sk1, sv1, sdm1 = superpoint_detect(sp_model, imgs1, dp)
        sva, svb = covisible(sk0, sv0, sk1, sv1, Hs, Hinvs, SIZE, SIZE)

    with phase("kernel D (nearest neighbours) vs plain nn_dists"):
        rows = torch.arange(K, device=dev)

        def pen_pair(da, va_, db, vb_):
            # covisibility leaves invalid rows; add more on both sides
            return (penalized(da, va_ & (rows % 9 != 0))[0],
                    penalized(db, vb_ & (rows % 11 != 0))[0])

        gen = torch.Generator(device=dev).manual_seed(3)
        big = [torch.randn((PAIRS, K_LARGE, 256), device=dev, generator=gen)
               for _ in range(2)]
        big = [penalized(x / x.norm(dim=-1, keepdim=True),
                         torch.rand((PAIRS, K_LARGE), device=dev,
                                    generator=gen) > 0.15)[0] for x in big]
        cases = [("SuperPoint D=257",
                  *pen_pair(sample_at_points(sdm0, sk0), sva,
                            sample_at_points(sdm1, sk1), svb)),
                 ("ALIKE-t D=65", *pen_pair(ext_k[0][0], ext_k[0][2],
                                            ext_k[1][0], ext_k[1][2])),
                 (f"random D=257, K={K_LARGE}", *big)]
        for name, a, b in cases:
            got = cuda_match.nn_dists_cuda(a, b)
            want = nn_dists(a, b)
            near, err_free, rel = check_nn(got, want, a, b)
            errs["nn_match"] = max(errs["nn_match"], err_free)
            log(f"  {name} [{a.shape[0]} pairs]: near-tie index differences "
                f"{near[0]} penalty-free, {near[1]} under a penalty, of "
                f"{2 * a.shape[0] * a.shape[1]}; d max abs err "
                f"{err_free:.3g} (penalty-free), {rel:.3g} of scale")
        ints = [torch.randint(-3, 4, (PAIRS, K, 65), device=dev,
                              generator=gen).float() for _ in range(2)]
        if not all(torch.equal(g, w) for g, w in zip(
                cuda_match.nn_dists_cuda(*ints), nn_dists(*ints))):
            raise AssertionError("kernel D differs from the plain twin on "
                                 "integer descriptors")

        match_t = {}
        for name, a, b in cases:
            ms, lib_ms, turns = in_turns(
                lambda: cuda_match.nn_dists_cuda(a, b), mm_min(a, b),
                iters=20, other_iters=10)
            plain_ms = cuda_ms(lambda: nn_dists(a, b), iters=5)
            bound_ms, bound_by = match_bound(a, b)
            # device time of a call (memset + 2 kernels), which the event
            # time above exceeds where the wrapper's host work paces calls
            busy, _, top = profile_step(
                lambda: [cuda_match.nn_dists_cuda(a, b) for _ in range(10)])
            dev_ms = busy / 10
            by_kernel = ", ".join(f"{k.split('(')[0]} {t / 10:.4f}"
                                  for k, t in top)
            match_t[name] = (ms, plain_ms, lib_ms, bound_ms, bound_by,
                             dev_ms)
            log(f"  {name}: kernel {ms:.4f} ms (device {dev_ms:.4f} ms; "
                f"{by_kernel}), plain "
                f"{plain_ms:.4f} ms, baddbmm + min {lib_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}); bound / device time "
                f"{bound_ms / dev_ms:.3f}; in turns "
                f"kernel, library, library, kernel: "
                f"{[round(t, 4) for t in turns]}")
        (match_ms, match_plain_ms, match_lib_ms, match_bound_ms,
         match_bound_by, match_dev_ms) = match_t["SuperPoint D=257"]
        d65 = match_t["ALIKE-t D=65"]
        big_t = match_t[f"random D=257, K={K_LARGE}"]

    with phase("kernel E (masked attention) vs plain fused_attention"):
        gen = torch.Generator(device=dev).manual_seed(2)

        def qkv(lead, n, m):
            return [torch.randn((*lead, r, 64), device=dev, generator=gen)
                    for r in (n, m, m)]

        def check_e(name, q, k, v, kv, scale=None):
            got = cuda_attention.attention_cuda(q, k, v, kv, scale)
            want = fused_attention(q, k, v, kv, scale)
            err = (got - want).abs()
            bad = err > 1e-5 + 1e-5 * want.abs()
            errs["attention"] = max(errs["attention"], float(err.max()))
            log(f"  {name}: max abs err {float(err.max()):.3g}, outside "
                f"1e-5 abs/rel: {int(bad.sum())}")
            if bool(bad.any()) or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"kernel E differs on {name}")
            return got

        lead = (2 * LG_PAIRS, 4)
        q, k, v = qkv(lead, K, K)
        kv = torch.rand((2 * LG_PAIRS, 1, K), device=dev, generator=gen) > 0.1
        for scale in (None, 1.0):
            check_e(f"[16,4,{K},64] scale {scale or 'dh^-0.5'}", q, k, v, kv,
                    scale)
        got = check_e("all keys invalid", q, k, v, torch.zeros_like(kv))
        if not torch.allclose(got, v.mean(-2, keepdim=True).expand_as(got),
                              atol=1e-5, rtol=1e-5):
            raise AssertionError("all-invalid rows are not uniform")
        q2, k2, v2 = qkv((3, 4), 333, 517)
        check_e("n=333, m=517", q2, k2, v2,
                torch.rand((3, 1, 517), device=dev, generator=gen) > 0.2)

        def sdpa(q, k, v, kv):
            """The library call timed beside kernel E: one
            scaled_dot_product_attention with the additive mask."""
            mask = torch.where(kv, 0.0, -1e9)[..., None, :]
            return lambda: F.scaled_dot_product_attention(q, k, v,
                                                          attn_mask=mask)

        att_ms, att_lib_ms, turns = in_turns(
            lambda: cuda_attention.attention_cuda(q, k, v, kv),
            sdpa(q, k, v, kv), iters=20, other_iters=10)
        att_plain_ms = cuda_ms(lambda: fused_attention(q, k, v, kv), iters=5)
        att_bound_ms, att_bound_by, exps = attention_bound(q, K)
        log(f"  [16,4,{K},64]: kernel {att_ms:.4f} ms, plain "
            f"{att_plain_ms:.4f} ms, sdpa {att_lib_ms:.4f} ms, bound "
            f"{att_bound_ms:.4f} ms ({att_bound_by}), {exps} exps; in turns "
            f"kernel, sdpa, sdpa, kernel: {[round(t, 4) for t in turns]}")
        got = cuda_attention.attention_cuda(q, k, v,
                                            cuda_attention.head_mask(kv[:, 0],
                                                                     4))
        if not torch.equal(got, cuda_attention.attention_cuda(q, k, v, kv)):
            raise AssertionError("head_mask changes kernel E's result")

    for matcher, pairs in (("brute_force", PAIRS), ("light_glue", LG_PAIRS)):
        with phase(f"superpoint_mha_step: {matcher}, {pairs} pairs at "
                   f"{SIZE}^2"):
            lgp = lg_params if matcher == "light_glue" else None
            args = (sp_model, imgs0[:pairs], imgs1[:pairs], Hs[:pairs],
                    Hinvs[:pairs], dp)

            def step(seed=0):
                return superpoint_mha_step(
                    *args, torch.Generator(device=dev).manual_seed(seed),
                    matcher, lgp, 5.0, 512, device=DEVICE)

            reset_launches()
            hits, m0, m1, ok = step()
            torch.cuda.synchronize()
            got = read_launches()
            need = "nn_match" if matcher == "brute_force" else "attention"
            log(f"  launches in one run: {got}")
            if got["nms"] <= 0 or got[need] <= 0:
                raise AssertionError(f"a kernel was not launched: {got}")
            launches[need] = got[need]
            with plain_twins():
                hits_p, m0_p, m1_p, ok_p = step()
            n_valid = int(sv0[:pairs].sum() + sv1[:pairs].sum())
            n_ok, n_ok_p = int(ok.sum()), int(ok_p.sum())
            rows_differ = int((ok != ok_p).sum() + (
                ok & ok_p & (m1 != m1_p).any(-1)).sum())
            hit_diff = int((hits != hits_p).any(-1).sum())
            log(f"  matches kernel {n_ok} plain {n_ok_p} of {n_valid} valid "
                f"keypoints; rows that differ {rows_differ}; MHA@3/5/7 "
                f"kernel {hits.mean(0).tolist()} plain "
                f"{hits_p.mean(0).tolist()}; pairs whose hits differ "
                f"{hit_diff}")
            if not (torch.equal(m0, m0_p) and hits.shape == (pairs, 3)
                    and bool(torch.isfinite(m1).all())
                    and bool(((hits == 0) | (hits == 1)).all())):
                raise AssertionError("MHA step outputs malformed or "
                                     "keypoints differ from plain")
            if abs(n_ok - n_ok_p) > 0.005 * n_valid / 2:
                raise AssertionError(f"match count {n_ok} vs plain {n_ok_p}")

            with torch.inference_mode():
                heat0, _ = sp_model(imgs0[:pairs])
                k0_, v0_, dm0_ = sk0[:pairs], sva[:pairs], sdm0[:pairs]
                k1_, v1_, dm1_ = sk1[:pairs], svb[:pairs], sdm1[:pairs]
                mk0, mk1, mok = match_pairs(matcher, k0_, v0_, k1_, v1_,
                                            dm0_, dm1_, SIZE, SIZE, 5.0, lgp)
                if matcher == "light_glue":
                    p0 = k0_[..., :2] * (SIZE - 1.0)
                    p1 = k1_[..., :2] * (SIZE - 1.0)
                    lg_in = (p0, v0_, sample_descriptors_lg(p0, dm0_, 8),
                             p1, v1_, sample_descriptors_lg(p1, dm1_, 8))
                    sc = {}
                    for n_layers in (2, 9):
                        sc[n_layers] = lightglue_scores(lg_params, *lg_in,
                                                        n_layers=n_layers)
                        with plain_twins():
                            sc[n_layers] = (sc[n_layers], lightglue_scores(
                                lg_params, *lg_in, n_layers=n_layers))
                    rel2 = close_scores(*sc[2])
                    live = sc[9][1] > -1e8
                    rel9 = float((sc[9][0] - sc[9][1])[live].norm()
                                 / sc[9][1][live].norm())
                    log(f"  LightGlue scores vs plain twins: 2 layers "
                        f"{rel2:.3g}, 9 layers {rel9:.3g} (relative norm)")
            windows = timed_windows(step)
            dt = statistics.median(windows)
            pps = [pairs / w for w in windows]
            log(f"  step: median {dt * 1e3:.3f} ms per {pairs}-pair batch, "
                f"{pairs / dt:.2f} pairs/s (min {min(pps):.2f}, max "
                f"{max(pps):.2f}) on {card}")
            gen_t = torch.Generator(device=dev).manual_seed(0)
            with torch.inference_mode():
                st = {f"forward, SuperPoint on {pairs} images":
                      cuda_ms(lambda: sp_model(imgs0[:pairs]), iters=5),
                      f"detection_batch, {pairs} maps":
                      cuda_ms(lambda: detection_batch(heat0, dp), iters=5),
                      "covisibility warp":
                      cuda_ms(lambda: covisible(k0_, sv0[:pairs], k1_,
                                                sv1[:pairs], Hs[:pairs],
                                                Hinvs[:pairs], SIZE, SIZE),
                              iters=5),
                      f"match: {matcher}":
                      cuda_ms(lambda: match_pairs(
                          matcher, k0_, v0_, k1_, v1_, dm0_, dm1_, SIZE,
                          SIZE, 5.0, lgp), iters=5),
                      "RANSAC-H + MHA":
                      cuda_ms(lambda: mha_pair(mk0, mk1, mok, Hs[:pairs],
                                               SIZE, SIZE, SIZE, SIZE,
                                               gen_t), iters=5)}
            for name, ms in st.items():
                log(f"  stage {name}: {ms:.4f} ms")
            busy, window, top = profile_step(step)
            log(f"  profiled step: device busy {busy:.3f} ms of a "
                f"{window:.3f} ms window, idle share "
                f"{1.0 - busy / window:.4f}" if window > 0 else
                "  profiled step: no events recorded")
            for name, ms in top:
                log(f"    device time {ms:.4f} ms: {name[:90]}")

    with phase("MHA runner: SuperPoint + light_glue, 4 pairs at 512^2"):
        cfg = EvalConfig(
            model_type="SuperPoint", task_type="MHA",
            data_params={"type": "synthetic_homography", "num_pairs": 4,
                         "image_size": SIZE},
            extractor_params={"nms_dist": 6, "border_dist": 8, "top_k": K,
                              "threshold": 0, "min_score": 0.0},
            matcher_params={"type": "light_glue"},
            task_params={"th": [3, 5, 7]},
            weights_dir=stage_golden_weights(os.path.join(
                ROOT, "output", "chip_smoke_weights")),
            output_dir=os.path.join(ROOT, "output", "chip_smoke_mha"))
        reset_launches()
        res = Evaluator(cfg, DEVICE).run()
        got = read_launches()
        with plain_twins():
            res_p = Evaluator(cfg, DEVICE).run()
        log(f"  MHA@3/5/7 {[res[f'MHA@{t}'] for t in (3, 5, 7)]} (plain "
            f"{[res_p[f'MHA@{t}'] for t in (3, 5, 7)]}); launches {got}")
        if got["attention"] <= 0 or got["nn_match"] != 0:
            raise AssertionError(f"the runner missed kernel E: {got}")
        if res["per_pair"] != res_p["per_pair"]:
            raise AssertionError("MHA runner differs from the plain twins")

    with phase(f"kernel E alone at K={K_LARGE}"):
        q4, k4, v4 = qkv(lead, K_LARGE, K_LARGE)
        kv4 = torch.rand((2 * LG_PAIRS, 1, K_LARGE), device=dev,
                         generator=gen) > 0.1
        check_e(f"[16,4,{K_LARGE},64]", q4, k4, v4, kv4)
        att4_ms, att4_lib_ms, turns = in_turns(
            lambda: cuda_attention.attention_cuda(q4, k4, v4, kv4),
            sdpa(q4, k4, v4, kv4), iters=3, other_iters=3)
        att4_plain_ms = cuda_ms(lambda: fused_attention(q4, k4, v4, kv4),
                                iters=2, warmup=1)
        att4_bound_ms, _, _ = attention_bound(q4, K_LARGE)
        log(f"  [16,4,{K_LARGE},64]: kernel {att4_ms:.4f} ms, plain "
            f"{att4_plain_ms:.4f} ms, sdpa {att4_lib_ms:.4f} ms, bound "
            f"{att4_bound_ms:.4f} ms; in turns kernel, sdpa, sdpa, kernel: "
            f"{[round(t, 4) for t in turns]}")
        # named here and not beside the first timing: the first profiled
        # call attaches the tracer, and every launch after it costs the
        # host more, which the brute-force step above should not pay
        call = sdpa(q, k, v, kv)
        _, _, top = profile_step(lambda: [call() for _ in range(5)], top=3)
        for name, ms in top:
            log(f"  sdpa's device kernels at K={K}, {ms / 5:.4f} ms a call: "
                f"{name[:110]}")
        if not top:
            raise AssertionError("the profiler named no device kernel of "
                                 "scaled_dot_product_attention")
        del q4, k4, v4

    lk = LKParams(distance=10.0, win_size=21, levels=3, iterations=40)
    with phase(f"data: {LK_PAIRS} consecutive-frame pairs of the synthetic "
               f"sequence at {SIZE}^2"):
        seq = SyntheticSequenceDataset(LK_PAIRS + 1, SIZE, 0)
        frames = torch.from_numpy(np.stack(
            [seq[i]["image0"] for i in range(LK_PAIRS + 1)])).to(dev)
        lk_imgs0, lk_imgs1 = frames[:-1].contiguous(), frames[1:].contiguous()
        lk_Fs = torch.from_numpy(seq.Fs[1:]).to(dev)
        with torch.inference_mode():
            lk_score, _ = model(lk_imgs0)
            lk_k0, lk_v0 = detection_batch(lk_score, dp)
        pyr0 = [lk_imgs0] + [_avg_pool_img(lk_imgs0, k) for k in (2, 4)]
        pyr1 = [lk_imgs1] + [_avg_pool_img(lk_imgs1, k) for k in (2, 4)]
        px_full = lk_k0[..., 0:2] * (SIZE - 1.0)

    with phase("kernel F (LK level) vs plain _lk_level"):
        gen = torch.Generator(device=dev).manual_seed(3)
        lk_loose_err = 0.0
        for win in (21, 3):
            for lvl in range(3):
                hl = SIZE // 2 ** lvl
                starts = {"keypoints": px_full / 2 ** lvl,
                          "border points": border_points(LK_PAIRS, K, hl, hl,
                                                         gen, dev)}
                for name, pts1 in starts.items():
                    pts2 = pts1 + (torch.rand(pts1.shape, generator=gen,
                                              device=dev) * 4 - 2)
                    args = (pyr0[lvl], pyr1[lvl], pts1, pts2, win, 8)
                    got = cuda_lk.lk_level_cuda(*args)
                    want = _lk_level(*args)
                    e = (got - want).abs().amax(-1)
                    n_out = int((e > 5e-3).sum())
                    err = float(e.max())
                    # a 3 x 3 window that hangs over the border of the
                    # smoothed block texture sees next to no gradient: the
                    # system is near-singular, rounding decides the step,
                    # and a few such points may end elsewhere
                    loose = win == 3 and name == "border points"
                    if loose:
                        lk_loose_err = max(lk_loose_err, err)
                    else:
                        errs["lk"] = max(errs["lk"], err)
                    log(f"  win {win} level {lvl} ({hl}^2) {name}: max abs "
                        f"err {err:.3g} px; beyond 5e-3 px: {n_out} of "
                        f"{e.numel()}")
                    if n_out:
                        det = lk_det(pyr1[lvl], want, win)
                        for bi, ni in (e > 5e-3).nonzero()[:5].tolist():
                            log(f"    pair {bi} point {ni}: "
                                f"{float(e[bi, ni]):.3g} px apart, det at "
                                f"the plain run's end {float(det[bi, ni]):.3g}")
                    if (n_out > (0.005 * e.numel() if loose else 0)
                            or not bool(torch.isfinite(got).all())):
                        raise AssertionError(f"kernel F differs: win {win} "
                                             f"level {lvl} {name}: {err}")
        angles = draw_angles((LK_PAIRS, K), gen, dev)
        flow_args = (lk_imgs0, lk_imgs1, lk_k0, lk_k0, angles, lk)
        got, _ = optical_flow_batch_from_angles(*flow_args)
        with plain_twins():
            want, _ = optical_flow_batch_from_angles(*flow_args)
        d = (got - want).abs().amax(-1) * (SIZE - 1.0)
        share = float((d <= 1e-2).float().mean())
        log(f"  full protocol (3 levels x 40 iterations, distance 10): "
            f"{share:.4%} of {d.numel()} points within 1e-2 px of the plain "
            f"run; median {float(d.median()):.3g} px")
        far = (d > 1e-2).nonzero()[:12]
        dets = lk_det(lk_imgs1, want * (SIZE - 1.0), lk.win_size)
        for bi, ni in far.tolist():
            log(f"    pair {bi} point {ni}: {float(d[bi, ni]):.3g} px apart, "
                f"det {float(dets[bi, ni]):.3g}, valid "
                f"{bool(lk_v0[bi, ni])}")
        if share < 0.99:
            raise AssertionError(f"kernel F full protocol: {share}")
        jit = torch.stack([torch.cos(angles), torch.sin(angles)], -1)
        start = (px_full + jit * lk.distance).clamp(10, SIZE - 10)
        # each level from the start the protocol gives it (the level
        # above's result): the kernel's time depends on how far a point
        # still has to go, since it loads a window only when its start moves
        lk_plain_ms, lk_level_ms, lk_turns, lk_loads = 0.0, [], [], []
        for lvl in (2, 1, 0):
            args = (pyr0[lvl], pyr1[lvl], px_full / 2 ** lvl,
                    start / 2 ** lvl, lk.win_size, lk.iterations)
            moves = torch.zeros(1, dtype=torch.int32, device=dev)
            start = cuda_lk.lk_level_cuda(*args, moves=moves) * 2 ** lvl
            lk_loads.append(int(moves.item()))
            ms, plain, turns = in_turns(
                lambda: cuda_lk.lk_level_cuda(*args),
                lambda: _lk_level(*args), iters=5, other_iters=1)
            lk_level_ms.append(ms)
            lk_turns.append([round(t, 4) for t in turns])
            lk_plain_ms += plain
        lk_ms = sum(lk_level_ms)
        lk_bound_ms, lk_bound_by, pt_iters, lk_bound_every_ms = lk_bound(
            lk_imgs0, K, lk.win_size, lk.levels, lk.iterations)
        per_level = LK_PAIRS * K * lk.iterations
        # the first iteration of a point always loads; the rest only when
        # the window's integer start moved
        moved = [(n_ - LK_PAIRS * K) / (per_level - LK_PAIRS * K)
                 for n_ in lk_loads]
        lk_moved_share = (sum(lk_loads) - lk.levels * LK_PAIRS * K) / (
            lk.levels * (per_level - LK_PAIRS * K))
        log(f"  [{LK_PAIRS} pairs, K={K}, win {lk.win_size}, "
            f"{lk.iterations} iterations] levels /4, /2, /1: "
            f"kernel {[round(t, 4) for t in lk_level_ms]} ms, sum "
            f"{lk_ms:.4f} ms ({lk_ms * 1e6 / pt_iters:.2f} ns per "
            f"point-iteration), plain {lk_plain_ms:.4f} ms, bound "
            f"{lk_bound_ms:.4f} ms ({lk_bound_by}; "
            f"{lk_bound_every_ms:.4f} ms with the gradients counted in "
            f"every iteration)")
        log(f"  in turns kernel, plain, plain, kernel per level: {lk_turns}")
        log(f"  window loads per level {lk_loads} of {per_level} "
            f"point-iterations; share of the iterations after a point's "
            f"first whose window start moved: "
            f"{[round(m_, 5) for m_ in moved]}, all levels "
            f"{lk_moved_share:.5f}")

    with phase(f"lk_fundamental_step: {LK_PAIRS} pairs at {SIZE}^2"):
        def lk_step(seed=0):
            return lk_fundamental_step(
                model, params, lk_imgs0, lk_imgs1, lk_Fs,
                torch.Generator(device=dev).manual_seed(seed), dp, lk,
                device=DEVICE)

        reset_launches()
        out, k0, v0, tracked = lk_step()
        torch.cuda.synchronize()
        got = read_launches()
        log(f"  launches in one lk_fundamental_step run: {got}")
        if got["nms"] <= 0 or got["lk"] != lk.levels:
            raise AssertionError(f"a kernel was not launched: {got}")
        launches["lk"] = got["lk"]
        with plain_twins():
            out_p, k0_p, v0_p, tracked_p = lk_step()
        n_valid = v0.sum(-1)
        err, err_p = out["fundamental_error"], out_p["fundamental_error"]
        num, num_p = out["fundamental_num"], out_p["fundamental_num"]
        log(f"  fundamental_error per pair {[round(x, 5) for x in err.tolist()]}"
            f" (plain {[round(x, 5) for x in err_p.tolist()]}); "
            f"fundamental_num {num.tolist()} (plain {num_p.tolist()}) of "
            f"{n_valid.tolist()} valid keypoints; radio "
            f"{[round(x, 4) for x in out['fundamental_radio'].tolist()]}")
        if not (torch.equal(k0, k0_p) and torch.equal(v0, v0_p)
                and torch.equal(k0, lk_k0)):
            raise AssertionError("keypoints differ from the plain-twin step")
        if not (bool(torch.isfinite(tracked).all())
                and tracked.shape == (LK_PAIRS, K, 2)
                and bool(torch.isfinite(err).all()) and int(num.min()) > 0):
            raise AssertionError("lk_fundamental_step outputs malformed")
        if not bool(((err - err_p).abs() <= 1e-3 * err_p.abs()).all()):
            raise AssertionError("fundamental_error differs from plain by "
                                 "more than 1e-3 relative")
        if not bool(((num - num_p).abs() <= 0.005 * n_valid).all()):
            raise AssertionError("fundamental_num differs from plain")

        windows = timed_windows(lk_step)
        dt = statistics.median(windows)
        lk_fps = LK_PAIRS / dt
        fps_all = [LK_PAIRS / w for w in windows]
        log(f"  lk_fundamental_step: median {dt * 1e3:.3f} ms per "
            f"{LK_PAIRS}-pair batch, {lk_fps:.2f} frames/s (min "
            f"{min(fps_all):.2f}, max {max(fps_all):.2f}) on {card}")
        scale = torch.tensor([SIZE - 1.0, SIZE - 1.0], device=dev)
        with torch.inference_mode():
            st = {f"forward, ALIKE-t on {LK_PAIRS} images":
                  cuda_ms(lambda: model(lk_imgs0), iters=5),
                  f"detection_batch, {LK_PAIRS} maps":
                  cuda_ms(lambda: detection_batch(lk_score, dp), iters=5),
                  "pyramids (avg pool /2 and /4 of 16 images)":
                  cuda_ms(lambda: [_avg_pool_img(im, k) for im in
                                   (lk_imgs0, lk_imgs1) for k in (2, 4)],
                          iters=5),
                  "LK level /4 (kernel F)": lk_level_ms[0],
                  "LK level /2 (kernel F)": lk_level_ms[1],
                  "LK level /1 (kernel F)": lk_level_ms[2],
                  "fundamental_metrics":
                  cuda_ms(lambda: fundamental_metrics(
                      k0[..., 0:2] * scale, tracked * scale, v0, lk_Fs),
                      iters=5)}
        for name, ms in st.items():
            log(f"  stage {name}: {ms:.4f} ms")
        busy, window, top = profile_step(lk_step)
        log(f"  profiled step: device busy {busy:.3f} ms of a "
            f"{window:.3f} ms window, idle share "
            f"{1.0 - busy / window:.4f}" if window > 0 else
            "  profiled step: no events recorded")
        for name, ms in top:
            log(f"    device time {ms:.4f} ms: {name[:90]}")

    with phase("kernel C (peel) vs plain peel_topk; fused detection"):
        nms16 = cuda_nms.nms_cuda(maps0, dp.nms_dist, 30)
        # three distinct bf16 values: far more than top_k maxima tie at the
        # top, so some chunk's eighth candidate still reaches the cutoff
        ties = (torch.round(torch.rand((2, SIZE, SIZE), device=dev,
                                       generator=gen) * 2) / 2).to(
            torch.bfloat16)
        # NaN in a few chunks (two in the border, which reads 0);
        # the maps' zeros as -0.0 on every other column, tying with +0.0
        nan2 = nms16[:2].clone()
        for b_, r_, c_ in ((0, 100, 300), (1, 200, 130), (1, 7, 130),
                           (1, 400, 5)):
            nan2[b_, r_, c_] = torch.nan
        cols = torch.arange(SIZE, device=dev)
        cases = [("NMS'd score maps x16", nms16),
                 ("tie-heavy", cuda_nms.nms_cuda(ties, 2, 30).float()),
                 ("sparse", torch.where(nms16[:2] > 0.6, nms16[:2], 0.0)),
                 ("NaN chunks", nan2),
                 ("-0.0 beside +0.0", torch.where(
                     (nms16[:2] == 0) & (cols % 2 == 0), -0.0, nms16[:2]))]
        for name, m in cases:
            v, i = cuda_nms.peel_cuda(m, dp.border_dist, 8)
            pv, pi = peel_topk(m, dp.border_dist, 8)
            nan = torch.isnan(pv)
            diff = float((v - pv).abs().nan_to_num(0.0).max())
            errs["peel"] = max(errs["peel"], diff)
            short = int(((m != 0).reshape(*m.shape[:2], -1, 128).sum(-1)
                         < 8).sum())
            rounds = peel_rounds(pv, 8).float()
            same = peel_equal(v, i, pv, pi)
            log(f"  {name}: values and indices equal={same} (NaN matching "
                f"NaN, {int(nan.sum())} NaN candidates); chunks with fewer "
                f"than 8 non-zero entries: {short}; rounds per chunk the "
                f"maps need (reckoned on the host from the plain peel's "
                f"candidates; the kernel does not count its rounds): mean "
                f"{float(rounds.mean()):.4f}, max {int(rounds.max())}")
            if not same:
                raise AssertionError(f"kernel C differs on {name}")
            if name == "NaN chunks" and not (
                    int(nan.sum()) == 16
                    and bool((pi[nan.nonzero(as_tuple=True)] == SIZE).all())):
                raise AssertionError("the NaN chunks' rounds are not (NaN, "
                                     "W)")
        reset_launches()
        with torch.inference_mode():
            fk, fv = detection_batch_fused(score0, dp)
        torch.cuda.synchronize()
        got = read_launches()
        log(f"  launches in one detection_batch_fused run: {got}")
        if got["nms"] <= 0 or got["peel"] != 1:
            raise AssertionError(f"a kernel was not launched: {got}")
        launches["peel"] = got["peel"]
        tie_dp = DetectParams(nms_dist=2, border_dist=8, top_k=K)
        with torch.inference_mode():
            for name, maps, p_, want_unsafe in (
                    ("score maps x16", maps0, dp, False),
                    ("tie-heavy", ties, tie_dp, True)):
                fk, fv = detection_batch_fused(maps, p_)
                pk, pv = detection_batch(maps, p_)
                unsafe = fused_topk(maps, p_, K)[2]
                log(f"  detection_batch_fused on {name}: keypoints equal="
                    f"{torch.equal(fk, pk)} masks equal="
                    f"{torch.equal(fv, pv)} full-sort guard taken={unsafe}")
                if not (torch.equal(fk, pk) and torch.equal(fv, pv)
                        and unsafe == want_unsafe):
                    raise AssertionError(f"fused detection on {name}")
            peel_ms = cuda_ms(lambda: cuda_nms.peel_cuda(nms16, 8, 8))
            peel_plain_ms = cuda_ms(lambda: peel_topk(nms16, 8, 8), iters=5)
            # the library yardstick: torch.topk of every 128-column chunk
            # of the same border-masked maps (values only: topk does not
            # promise kernel C's lowest-index order on ties)
            masked = remove_border(nms16.float(), dp.border_dist)
            pb, ph, pw = masked.shape

            def chunk_topk():
                return torch.topk(masked.view(pb, ph, pw // 128, 128), 8,
                                  dim=-1)

            if not torch.equal(chunk_topk()[0].reshape(pb, ph, -1),
                               cuda_nms.peel_cuda(nms16, 8, 8)[0]):
                raise AssertionError("torch.topk's values differ from "
                                     "kernel C's")
            peel_turn_ms, topk_ms, peel_turns = in_turns(
                lambda: cuda_nms.peel_cuda(nms16, 8, 8), chunk_topk,
                iters=20, other_iters=20)
            det_fused_ms, det_ms, det_turns = in_turns(
                lambda: detection_batch_fused(score0, dp),
                lambda: detection_batch(score0, dp), iters=5, other_iters=5)
        # device time of a call (after the timed turns: a process that
        # has profiled once pays more per launch)
        busy, _, top = profile_step(
            lambda: [cuda_nms.peel_cuda(nms16, 8, 8) for _ in range(10)])
        peel_dev_ms = busy / 10
        by_kernel = ", ".join(f"{k.split('(')[0]} {t / 10:.4f}"
                              for k, t in top)
        busy, _, _ = profile_step(lambda: [chunk_topk() for _ in range(10)])
        topk_dev_ms = busy / 10
        peel_bound_ms, peel_bound_by = peel_bound(nms16, 8, 8)
        log(f"  {list(nms16.shape)} border 8, per_chunk 8: kernel "
            f"{peel_ms:.4f} ms (device {peel_dev_ms:.4f} ms; {by_kernel}), "
            f"plain {peel_plain_ms:.4f} ms, bound {peel_bound_ms:.4f} ms "
            f"({peel_bound_by}); device time / bound "
            f"{peel_dev_ms / peel_bound_ms:.3f}; torch.topk of the chunks "
            f"{topk_ms:.4f} ms in turns with the kernel's {peel_turn_ms:.4f} "
            f"(kernel, topk, topk, kernel: "
            f"{[round(t, 4) for t in peel_turns]}; topk / kernel "
            f"{topk_ms / peel_turn_ms:.2f}), device time {topk_dev_ms:.4f} "
            f"ms (topk / kernel {topk_dev_ms / peel_dev_ms:.2f}); "
            f"detection_batch {det_ms:.4f} ms, "
            f"detection_batch_fused {det_fused_ms:.4f} ms; in turns fused, "
            f"unfused, unfused, fused: {[round(t, 4) for t in det_turns]}")

    with phase("FundamentalMatrix runner: optical_flow, 5 frames at 512^2"):
        for pipelined in (False, True):
            cfg = EvalConfig.from_yaml(os.path.join(
                ROOT, "configs", "fund_synthetic.yaml"))
            cfg.data_params = {**cfg.data_params, "num_frames": 5,
                               "image_size": SIZE}
            cfg.task_params = {**cfg.task_params, "pipelined": pipelined}
            cfg.output_dir = os.path.join(ROOT, "output", "chip_smoke_fund")
            reset_launches()
            res = Evaluator(cfg, DEVICE).run()
            got = read_launches()
            with plain_twins():
                res_p = Evaluator(cfg, DEVICE).run()
            e, e_p = (np.asarray(r["per_frame_error"]) for r in (res, res_p))
            log(f"  pipelined={pipelined}: per_frame_error "
                f"{np.round(e, 5).tolist()} (plain "
                f"{np.round(e_p, 5).tolist()}); fundamental_num "
                f"{res['fundamental_num']} (plain {res_p['fundamental_num']})"
                f"; launches {got}")
            want_lk = lk.levels * (1 if pipelined else 5)
            if got["lk"] != want_lk or got["nms"] <= 0:
                raise AssertionError(f"the runner missed kernel F: {got}")
            if not (np.isfinite(e).all() and len(e) == 5
                    and (np.abs(e - e_p) <= 1e-3 * np.abs(e_p) + 1e-5).all()
                    and abs(res["fundamental_num"] - res_p["fundamental_num"])
                    <= 0.005 * K):
                raise AssertionError("FundamentalMatrix runner differs from "
                                     "the plain twins")

    auc = auc_phases(dev, dp, card, errs)
    vo = vo_phases(dev, dp, card, errs)
    det = detector_phases(dev, card, errs)
    d4, d513 = det["match_widths"][4], det["match_widths"][513]
    bf = bf16_phases(dev, card, errs, {
        "imgs0": imgs0, "imgs1": imgs1, "items": items, "Hs": Hs,
        "Hinvs": Hinvs, "model": model, "params": params,
        "sp_model": sp_model, "rep": rep,
        "lk": (lk_imgs0, lk_imgs1, lk_Fs, lk), "auc": auc["data"],
        "auc_cfg": auc["runner_cfg"], "auc_runner": auc["runner"],
        "vo": vo["data"]})
    sb = bf["sample_bf16"]
    fl = file_phases(dev, card, errs)
    ad = adaptive_phases(dev, card, errs, {
        "superpoint": (sk0, sva, sdm0, sk1, svb, sdm1),
        "lightglue": lg_params,
        "weights_dir": stage_golden_weights(os.path.join(
            ROOT, "output", "chip_smoke_weights"))})
    fp = five_point_phases(dev, card, auc)
    te = tracking_error_phases(dev, card, errs)
    tracks = {k: v["launches"] for k, v in te.items()}
    lc = loop_closure_phases(dev, card, errs)
    si = save_images_phases(dev, card)
    par = parallel_phases(dev, card, errs, {
        "items": items, "sp_model": sp_model, "auc": auc["data"],
        "auc_items": auc["items"], "vo": vo["data"],
        "vo_window": vo["window"], "lightglue": lg_params,
        "superpoint": (sk0, sva, sdm0, sk1, svb, sdm1)})
    spp = sp_pp_phases(dev, card, errs, {
        "lightglue": lg_params, "superpoint": (sk0, sva, sdm0, sk1, svb, sdm1),
        "imgs0": imgs0, "eval_alike": par["eval_Alike"],
        "weights_dir": stage_golden_weights(os.path.join(
            ROOT, "output", "chip_smoke_weights"))})
    cd = convert_demo_phases(dev, card, errs)
    dl = cd["disk_lightglue"]

    def parallel_launches(kernel):
        """The kernel's launches on the data-parallel steps (phases 50-52)
        at world 1 and PAR_WORLD, and on the sharded VO solves (55)."""
        dp = {k: {w: v[f"launches_world{w}"].get(kernel) for w in
                  (1, PAR_WORLD)} for k, v in par.items()
              if k.startswith("eval_") or k in ("mha", "auc")}
        dp = {k: v for k, v in dp.items() if v[1] is not None}
        return {"launches_data_parallel": dp}

    def loop_launches(kernel):
        """The kernel's launches on phase 46's and 47's paths."""
        return {"launches_loop_closure": {
            p: lc[p]["launches"][kernel] for p in ("strong", "scaled")}}

    def file_backed(kernel, prefix):
        """The kernel's launches on each file-backed config's run and its
        numbers at those configs' shapes (phases 33-40)."""
        return {"launches_file_configs": {n: got[kernel] for n, got in
                                          fl["launches"].items()},
                "file_shapes": {k: v for k, v in fl["shapes"].items()
                                if k.startswith(prefix)}}

    kernels = [
        {"name": "nms_fixpoint", "route": "cuda",
         "source": "keypoint_bench_tpu_torch/csrc/nms.cu",
         "replaces": "keypoint_bench_tpu/ops/pallas_nms.py:87",
         "launches": launches["nms"], "max_abs_err": errs["nms"],
         "ms": nms_ms, "plain_ms": nms_plain_ms, "bound_ms": nms_bound_ms,
         "bound_by": nms_bound_by, "library_ms": None,
         "bound_ms_full_rounds": nms_full_ms,
         "launches_per_call": nms_per_call,
         "ms_by_max_iter": {str(it): ms for it, ms in split.items()},
         "grid_blocks": min(blocks, tiles), "tiles_mask_per_round": k_mask,
         "tiles_suppression_per_round": k_supp[1:],
         "launches_xfeat_auc_step": auc["launches"]["nms"],
         "launches_vo_step": vo["launches"]["nms"],
         "launches_dense_extract_match":
             det["launches_dense_extract_match"]["nms"],
         "launches_fund_letnet_lk": det["launches_fund_letnet_lk"]["nms"],
         "launches_tracking_error": {k: v["nms"] for k, v in tracks.items()},
         **loop_launches("nms"),
         **file_backed("nms", "nms "),
         **parallel_launches("nms"),
         "launches_pipeline_extract": spp["pipeline"]["launches_nms"],
         "launches_demo": cd["demo"]["launches"]["nms"]},
        {"name": "sparse_sample", "route": "cuda",
         "source": "keypoint_bench_tpu_torch/csrc/sample.cu",
         "replaces": "keypoint_bench_tpu/ops/pallas_sample.py:107",
         "launches": launches["sample"], "max_abs_err": errs["sample"],
         "ms": samp_ms, "plain_ms": samp_plain_ms, "bound_ms": samp_bound_ms,
         "bound_by": samp_bound_by, "library_ms": None,
         "device_ms": samp_dev_ms, "ms_original_order": samp_orig_ms,
         "device_ms_original_order": samp_dev["original"],
         "sector_bound_ms": samp_sector_ms,
         "sector_bound_by": samp_sector_by,
         "launches_vo_step": vo["launches"]["sample"],
         **loop_launches("sample"),
         **file_backed("sample", "sample "),
         **parallel_launches("sample")},
        {"name": "nn_match", "route": "cuda",
         "source": "keypoint_bench_tpu_torch/csrc/match.cu",
         "replaces": "keypoint_bench_tpu/ops/pallas_match.py:29",
         "launches": launches["nn_match"], "max_abs_err": errs["nn_match"],
         "ms": match_ms, "plain_ms": match_plain_ms,
         "bound_ms": match_bound_ms, "bound_by": match_bound_by,
         "library_ms": match_lib_ms, "device_ms": match_dev_ms,
         "ms_d65": d65[0], "device_ms_d65": d65[5], "plain_ms_d65": d65[1],
         "library_ms_d65": d65[2], "bound_ms_d65": d65[3],
         f"ms_k{K_LARGE}": big_t[0], f"device_ms_k{K_LARGE}": big_t[5],
         f"library_ms_k{K_LARGE}": big_t[2],
         f"bound_ms_k{K_LARGE}": big_t[3],
         "launches_vo_step": vo["launches"]["nn_match"],
         "launches_dense_extract_match":
             det["launches_dense_extract_match"]["nn_match"],
         **{f"{k}_d{d}": t[k] for d, t in ((4, d4), (513, d513))
            for k in ("ms", "device_ms", "plain_ms", "library_ms",
                      "bound_ms", "bound_by")},
         **loop_launches("nn_match"),
         **{f"{k}_loop_closure": lc["strong"]["kernel_d"][k] for k in (
             "shape", "ms", "plain_ms", "library_ms", "bound_ms",
             "bound_by")},
         **file_backed("nn_match", "nn_match "),
         **parallel_launches("nn_match"),
         "launches_vo_sharded": {w: v["launches_nn_match"] for w, v in
                                 par["vo_sharded"].items()
                                 if isinstance(v, dict)},
         "launches_demo": cd["demo"]["launches"]["nn_match"]},
        {"name": "attention", "route": "cuda",
         "source": "keypoint_bench_tpu_torch/csrc/attention.cu",
         "replaces": "keypoint_bench_tpu/ops/pallas_attention.py:33",
         "launches": launches["attention"],
         "max_abs_err": errs["attention"], "ms": att_ms,
         "plain_ms": att_plain_ms, "bound_ms": att_bound_ms,
         "bound_by": att_bound_by, "library_ms": att_lib_ms,
         f"ms_k{K_LARGE}": att4_ms, f"plain_ms_k{K_LARGE}": att4_plain_ms,
         f"library_ms_k{K_LARGE}": att4_lib_ms,
         f"bound_ms_k{K_LARGE}": att4_bound_ms,
         "launches_xfeat_auc_step": auc["launches"]["attention"],
         **{f"{k}_adaptive{'' if mode == 'default' else '_' + mode}": v
            for mode in ("default", "pruning") for k, v in (
                ("launches_per_pair", [r["launches"] for r in
                                       ad[mode]["pairs"]]),
                ("i_fin_median", ad[mode]["i_fin_median"]),
                ("ms", ad[mode]["e_ms_call"]),
                ("plain_ms", ad[mode]["plain_ms_call"]),
                ("bound_ms", ad[mode]["bound_ms_call"]),
                ("bound_by", ad[mode]["bound_by"]),
                ("library_ms", ad[mode]["sdpa_ms_call"]))},
         "launches_mha_runner_adaptive": ad["runner_launches"],
         "launches_lightglue_tp": {n: v["launches_attention"]
                                   for n, v in par["tp"].items()},
         "launches_lightglue_sp": {w: spp["sp"][f"world{w}"][
             "launches_attention"] for w in SP_WORLDS},
         **{f"{k}_disk_lightglue_{mode}": dl[mode][v] for mode in dl
            for k, v in (("launches", "launches"),
                         ("launches_per_pair", "launches_per_pair"),
                         ("shape", "shape"), ("ms", "e_ms_call"),
                         ("plain_ms", "plain_ms_call"),
                         ("bound_ms", "bound_ms_call"),
                         ("bound_by", "bound_by"),
                         ("library_ms", "sdpa_ms_call"))}},
        {"name": "lk_level", "route": "cuda",
         "source": "keypoint_bench_tpu_torch/csrc/lk.cu",
         "replaces": "keypoint_bench_tpu/ops/pallas_lk.py:78",
         "launches": launches["lk"], "max_abs_err": errs["lk"],
         "ms": lk_ms, "plain_ms": lk_plain_ms, "bound_ms": lk_bound_ms,
         "bound_by": lk_bound_by, "library_ms": None,
         "bound_ms_gradients_every_iteration": lk_bound_every_ms,
         "window_loads_per_level": lk_loads,
         "moved_start_share": lk_moved_share,
         "max_abs_err_win3_border": lk_loose_err,
         "ms_per_level": lk_level_ms, "step_frames_per_s": lk_fps,
         "launches_vo_runner_lk": vo["launches_lk"],
         "launches_fund_letnet_lk": det["launches_fund_letnet_lk"]["lk"],
         "launches_tracking_error": {k: v["lk"] for k, v in tracks.items()},
         **loop_launches("lk"),
         **file_backed("lk", "lk_level ")},
        {"name": "peel_topk", "route": "cuda",
         "source": "keypoint_bench_tpu_torch/csrc/peel.cu",
         "replaces": "keypoint_bench_tpu/ops/pallas_nms.py:127",
         "launches": launches["peel"], "max_abs_err": errs["peel"],
         "ms": peel_ms, "plain_ms": peel_plain_ms, "bound_ms": peel_bound_ms,
         "bound_by": peel_bound_by, "library_ms": topk_ms,
         "ms_in_turns_with_library": peel_turn_ms, "device_ms": peel_dev_ms,
         "library_device_ms": topk_dev_ms,
         "detection_batch_ms": det_ms,
         "detection_batch_fused_ms": det_fused_ms},
        {"name": "sparse_sample_bf16", "route": "cuda",
         "source": "keypoint_bench_tpu_torch/csrc/sample.cu",
         "replaces": "keypoint_bench_tpu/ops/pallas_sample.py:107",
         "launches": bf["launches"]["sample_bf16"],
         "max_abs_err": errs["sample_bf16"], "ms": sb["ms"],
         "plain_ms": sb["plain_ms"], "bound_ms": sb["bound_ms"],
         "bound_by": sb["bound_by"], "library_ms": None,
         "device_ms": sb["device_ms"],
         "f32_kernel_ms_same_values": sb["f32_ms_same_values"],
         "f32_kernel_device_ms": sb["f32_device_ms"],
         "ms_original_order": sb["ms_original_order"],
         "device_ms_original_order": sb["device_ms_original_order"],
         "sector_bound_ms": sb["sector_bound_ms"],
         "sector_bound_by": sb["sector_bound_by"],
         "launches_vo_step": bf["launches_vo_step"]},
        {"name": "bn_epilogue", "route": "cuda",
         "source": "keypoint_bench_tpu_torch/csrc/bn_epilogue.cu",
         "replaces": None, "launches": launches["bn_epilogue"],
         "max_abs_err": errs["bn_epilogue"],
         **{k: bn["shapes"][-1][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "device_ms",
             "plain_device_ms")},
         "library_ms": None,
         "launches_per_forward": bn["launches_per_forward"],
         "shapes": bn["shapes"]},
    ]
    log(json.dumps({"xfeat_auc_step": {k: auc[k] for k in (
        "pairs_per_s", "stages_ms", "idle_share", "ransac_ms",
        "ransac_host_syncs", "runner")}}))
    log(json.dumps({"vo_step": {k: vo[k] for k in (
        "frames_per_s", "stages_ms", "idle_share", "host_syncs",
        "peak_memory_gb", "ba_window", "ba_card_vs_cpu", "ate_planar",
        "runner")}}, default=float))
    log(json.dumps({"dense_extract_match": {
        "models": det["models"], "sweep_repeatability": det["sweep"],
        "sweep_repeatability_jax_cpu": JAX_CPU_SWEEP,
        "sfd2_stability_flips": det["sfd2_stability_flips"],
        "seconds": det["seconds"]}}, default=float))
    log(json.dumps({"bf16": {k: bf[k] for k in (
        "steps", "forward_ulps_card_vs_cpu", "seconds")}}, default=float))
    log(json.dumps({"file_backed": {k: fl[k] for k in (
        "configs", "loader", "resume", "seconds")}}, default=float))
    log(json.dumps({"adaptive_lightglue": {k: ad[k] for k in (
        "default", "pruning", "host_syncs_per_pair", "ms_adaptive_pair",
        "ms_fixed_depth_pair", "emptied_calls", "runner")},
        "five_point": fp, "tracking_error": te}, default=float))
    log(json.dumps({"loop_closure": lc, "save_images": si}, default=float))
    log(json.dumps({"parallel": par}, default=float))
    log(json.dumps({"sp_pp": spp}, default=float))
    log(json.dumps({"convert_demo": cd}, default=float))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
