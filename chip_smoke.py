#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: build, check, drive.

    python3 chip_smoke.py [--batches 1 8] [--train-batch 4]
                          [--train-steps 3] [--out details.json]
                          [--profile table.txt] [--before DIR]

Phases (any failure exits non-zero and prints no result line):
  1. device — the card's name and power limit, torch/CUDA versions, and the
     nvcc build of the kernels from findnpropagate_torch/ops/csrc/ (three
     sources, one nvcc each, in parallel) into build/kernels/ (with ptxas'
     register / shared-memory report; a register spill in any kernel fails
     the run);
  2. kernels — synthetic corner cases of K2, K3 and K4 at full channel
     widths (a dense cube where all 27 neighbours hit, a window too small,
     blocks of sentinels at the end, a dead block in the middle, Cout 10
     and 3, Cin 4, batch 1 and 4; for K3 also a transposed 128->64 strided
     conv with its window staged and not, and epilogue rows of real
     targets without neighbours; `wide_corners`: K3 and K4 at tap groups
     of one (2D (1, 3, 3) kernels, submanifold and (1, 2, 2)-strided) and
     of five (5x5x5 stride 2, 32->64 and 64->128), K2 / K3 / K4 at 128->256
     and 256->256, K3 also transposed, the channel slices' launches
     printed; UNetV2's (3, 1, 1) stride-(2, 1, 1) conv_out, a single tap
     group at K1 / K2 too, and a 128->64 merge conv) against their plain
     versions, K1 on each
     of them and on its own corners (tap windows with tap overflow,
     windows too large to stage, no sentinel); then a batch-1 forward of
     the main path records the arguments of every call of K1
     (compute_positions, one launch per level) and K2 (posgather conv);
     each recorded call is re-run through the kernel and through its plain
     PyTorch version on the card: K1 bit-equal in all five fields (lo,
     base, pos, has_real, overflow; also with the prelude given,
     `positions`), K2 within its tolerance. Times are CUDA events after a
     warm-up, around a loop of eager wrapper calls (`ms`) and, for K1, K2
     and K3, around replays of a CUDA graph of the same calls
     (`device_ms`: at batch 1 the eager loop is bound by the host's launch
     work; a K1 call that synced could not be captured); K1 also with
     its window searched in device memory instead of staged in shared
     memory (bit-equal, device ms); the first K1 call also counts, under
     torch.profiler, the stream syncs and host-to-device copies of 5
     calls, which must be 0, and splits its host time under cProfile;
     then P2 and P3 (the probes' kernels) against their plain versions
     where the probes do not reach (`probe_corners`: rel and columns out
     of range, ids beyond tap_win and absent, S not a multiple of 8, one
     tile, 9 taps, windows at the shared-memory limit and one row more
     refused), and a duplicate id that makes P2's kernel fail the launch;
  3. main path — TransFusion-LiDAR from
     tools/cfgs/nuscenes_models/transfusion_lidar.yaml at full width,
     random weights (init_random_, seed 0), 200k-point lidar_ring scenes,
     forward + post_process at each batch size: detections finite,
     sparse_window_overflow == 0, 6 K1 and 16 K2 launches per forward;
     ms/scan and scans/s (median of chained runs), actives per level, peak
     memory;
  4. reference — a narrow model on a cropped scene, on the card and on the
     CPU (plain versions, f32): same actives, outputs within bf16 error;
  5. training path — the same yaml at full width in training mode, batch 4
     (BATCH_SIZE_PER_GPU) of training scenes with their 40 boxes, adam at
     lr 1e-4 with clip 10 (bench.py's optimizer): one warm-up step, then
     timed steps at accum_steps=1 and one at accum_steps=2: finite loss and
     gradient norm, sparse_window_overflow == 0, matched ground truths > 0,
     parameters changed, and per step 3 K1, 13 + 12 K2, 3 + 3 K3 and 16 K4
     launches; ms/step, scans/s, the host time of the Hungarian matching,
     and the peak memory of the timed steps alone (counted from after the
     warm-up). One more step, untimed, has the arguments of its K1, K2
     (forward and backward), K3 (windowed conv, forward and transposed) and
     K4 (weight gradient) launches recorded. Last, one step at batch 1
     with SUBM_IMPL: pallas (every sparse conv through K3 and K4) against a
     posgather-mode step on the same scene and weights: loss within 1e-3,
     overflow 0, 0 K1, 0 K2, 16 + 15 K3 and 16 K4 launches;
  6. training kernels — every recorded call is re-run through the kernel
     and through its plain PyTorch version on the card (K2, K3, K4 sample
     by sample): K1 at batch 4 bit-equal as in phase 2, the others within
     the stated
     tolerance; times as in phase 2; K3's device time with the window
     slice staged in shared memory and searched in device memory at a
     strided call;
  7. pallas-mode forward — a batch-1 eval forward with SUBM_IMPL: pallas
     (every sparse conv through K3 with the fused scale/shift/ReLU/sentinel
     epilogue): each of its 16 K3 launches against the plain version with
     the same epilogue, the forward against the posgather forward on the
     same weights, within bf16 error, and its ms/scan;
  8. probes — the six ported probes of tools/ (findnpropagate_torch/tools/
     probe_gather, probe_gather2, probe_gather3, probe_posgather,
     probe_posgather2 --mode cpu and --mode gpu, probe_posgather3) at their
     own shapes on the card, each exiting 0 (every variant right), with
     the launches of their three kernels (P1 take_along, P2 onehot_gather,
     P3 banded_gather_conv; ops/csrc/gather_probes.cu) counted; then every
     P1-P3 call of that run (but the repeats of the probes' timing loops)
     through the kernel and through its plain version on the card: P1 and
     P2 without weights bit-equal (NaN included), P2 with weights and P3
     within 1e-3 of the output's scale plus one bf16 step of each element;
     for the first call of each signature ms, device ms, plain ms, bound,
     the library call's time (torch.take_along_dim for P1), the wrapper's
     host time split under cProfile and, for P2 and P3, the syncs,
     host-to-device copies and launches per call under torch.profiler
     (0, 0 and 1, or the run fails). K1's rows
     of phases 2 and 6 carry the library call that computes its ranks,
     torch.searchsorted of all G*Vt queries in one call (its ranks checked
     against K1's where the id is found);
  9. seeker — the Greedy Box Seeker (findnpropagate_torch/openvocab/), no
     kernel of its own: FrustumProposerOG from
     tools/cfgs/nuscenes_models/nuscenes_box_seeker_proposals.yaml at
     bench.py:277-328's shape (numpy seed 0: the 6-camera yaw ring, 200k
     points, 96 detections written as per-camera COCO files under
     build/seeker_dets/ and read back through PreprocessedDetector.infer):
     ms/frame and frames/s (median of 10 propose calls by CUDA events after
     2 warm-ups), host syncs per frame (at most 2), copies and launches per
     frame under the profiler, peak memory, and with --profile the busy
     share and top kernels of one frame (table in <file>.seeker.txt); the
     card's output against the port's own CPU run: valid and labels equal,
     per valid detection boxes within 1e-4 and oracle within 1e-3, unless
     the CPU's two best oracle scores lie within 1e-3 (printed with the
     margin). Then the SEG seeker on the same frame (PointNet weights from
     torch's initialisation at seed 0, the output bias at the median logit
     of the frame's filtered points), its foreground masks and its output
     against the CPU's (a mask may differ only where a point's probability
     lies within 1e-4 of a threshold), and one frame of the KITTI seeker
     (its yaml, a synthetic calibration, 120k points, 32 detections through
     infer_kitti) against the CPU's;
 10. propagate — self-training through the port's entry point,
     findnpropagate_torch/tools/train_st.py's main with arguments, on
     tools/cfgs/nuscenes_models/transfusion_lidar_st.yaml at full width
     (6 known classes of 10, 200 proposals, unknown_cls_weight 0.6, its
     capacities and augmentations, adam_onecycle at batch 4) with the main
     path's backbone (transfusion_lidar.yaml's BACKBONE_3D, whose path
     launches K1-K4; phase 12 runs the yaml's own) over 8 of bench.py's
     200k-point lidar_ring training scenes, weights from init_random_(seed
     0); its
     inputs written under build/st_smoke/: a gt database of 8 further
     scenes through build_shared_database (read as a memmap), and a
     frustum store of unknown-class boxes (bicycle, pedestrian and cone
     sizes) centred on each frame's points (numpy seed 0), each holding 5
     points or more and overlapping no ground truth. 2 epochs, st_warmup 1:
     epoch 0 trains 2 steps, epoch 1 extracts pseudo labels over the 8
     frames and trains 2 steps. Gates: per step finite loss and gradient
     norm, overflow 0, pseudo boxes in the batch, 3 K1, 25 K2, 6 K3 and 16
     K4 launches; 6 K1 and 16 K2 per extraction batch; parameters changed;
     a non-empty copy-paste queue; unknown-class targets in the loss; 8
     self-train files stamped with epoch 1; BN statistics unchanged by the
     extraction. Printed with the card's name and power limit: ms per step
     (CUDA events, median of epoch 1), wall ms per iteration and the wait
     for the batch, the loader's host ms per batch, extraction ms per
     frame, pseudo boxes per frame, copy-paste samples per batch, peak
     memory, and with --profile the busy share of one epoch-1 iteration.
     Then the extraction CLI's frame loop (extract_frames) on phase 9's
     bench frame through a wrapper that supplies its camera_paths: the
     store equal to the seeker's valid proposals;
 11. open vocabulary — phase 10's model and 8 frames at batch 4, the
     extraction run once plain and once per CLIP_TYPE (GLIP, CROP,
     MASKCLIP) through self_training.build_relabeler on the ST yaml's
     OPTIMIZATION with CLIP_UNK_RELABEL, its batches given phase 9's
     6-camera rig (lidar2image) and image names (camera_paths, GLIP reads
     phase 9's per-camera COCO files through PreprocessedDetector.infer),
     CROP and MASKCLIP six seeded 900x1600 images a frame and seeded
     stand-ins for the encoders alone (their weights are not in the
     repository): the projection, crops, normalisation, softmax, resize
     and per-box means run on the card. Gates: 6 K1 and 16 K2 launches
     per extraction batch, in each mode a stored label that differs from
     the plain extraction's, and on one frame the card's labels equal to
     the port's CPU run and its scores within 1e-5 (OV_TOL). Printed with
     the card's name and power limit: relabel ms per frame (CUDA events
     around each call, the call ends in its results' copies to the host),
     host syncs and copies per call, peak
     memory. Then memory_ensemble with each NAME over the plain and GLIP
     labels of every frame, and recall_record (known: the 6 known
     classes) against each frame's ground truth and its unknown frustum
     boxes for every store (detections scored >= the yaml's SCORE_THRESH;
     IoU thresholds 0.01 and 0.1 beside the yaml's 0.3, 0.5 and 0.7), the
     card's equal to the CPU's. Last, the extraction CLI's alt mode
     (extract_frames) on phase 9's bench frame for every name of
     ALT_PROPOSER_REGISTRY (GTProposals on 24 seeded ground truths,
     CLIP2Scene on seeded per-point labels): a store written, boxes
     finite, ms per frame, the FrustumProposer's HDBSCAN point count and
     time, and its labels on the first 4000 points equal on card and CPU;
 12. the paper's yaml as written — train_st.main on
     tools/cfgs/nuscenes_models/transfusion_lidar_st.yaml with its own
     DATASET (NuScenesDataset) and BACKBONE_3D (the gather backbone), at
     full width (1440x1440x41 grid, MAX_VOXELS 120000, batch 4, MAX_SWEEPS
     10), only DATA_PATH set: a nuScenes-layout tree written under
     build/st_paper/nuscenes from 3 of bench.py's 200k-point lidar_ring
     scenes with objects of all 10 classes (the v1.0 JSON tables, key
     frames and chains of 9 sweeps of 11,111 points each; scene 0 val,
     scene 1 train), its infos and gt database through the port's
     create_nuscenes_infos / create_groundtruth_database, a frustum store
     of unknown-class boxes; 2 epochs, st_warmup 1 (the 2 train frames
     resampled by CBGS). Gates: NuScenesDataset and gather mode, per step
     finite loss and gradient norm, overflow 0 and no K1-K4 launch,
     parameters changed, the self-train store stamped 1 with boxes on every
     frame, NuScenesDataset.evaluation of those labels finite (mAP, NDS,
     AP_B, AP_N, AR_N over the 6 known classes of 10), a narrow gather-mode
     model on a cropped scene with the same actives on the card and the
     CPU and outputs within 1e-4 (float32, cuDNN's TF32 off) and within
     1e-3 under PyTorch's default flags (as train_st runs), and the
     extraction CLI's KITTI mode through KittiDataset (a KITTI tree of 2
     frames: velodyne, label_2, calib, ImageSets; phase 9's calibration and
     cached boxes) on the card equal to its CPU run (boxes 1e-4, scores
     1e-3). Printed with the card's name and power limit: gather mode's ms
     per step (CUDA events, median of epoch 1) beside phase 10's posgather
     mode, wall ms per iteration and the wait for the batch, peak memory,
     the evaluation's host ms; on the yaml's own levels, one batch's
     training forward + backward in gather and posgather mode, and in
     gather mode with the two gathers sparse_ops does not use (one shared
     zero row, by indexing or as F.embedding's padding_idx; same loss
     within 1e-5);
 13. CenterPoint — tools/cfgs/nuscenes_models/
     cbgs_voxel0075_res3d_centerpoint.yaml (SUBM_IMPL pallas, 1440x1440x41
     grid) and cbgs_voxel01_res3d_centerpoint.yaml (posgather, 1080x1080x41)
     as written at full width (six head groups, 64 shared channels),
     weights init_random_(seed 0), bench.py's 200k-point lidar_ring scenes
     in each yaml's range and voxel size: one batch-4 forward of the yaml
     as written (its overflow printed: its L0 windows, sized by hand for
     the reference's TPU kernel, drop neighbours on these scenes), then,
     with the main path's L0 windows (CP_WIDEN), eval forward +
     post_process at batch 1 and 4 (finite detections, overflow 0; 16 K3 a
     forward for
     0075, 6 K1 and 16 K2 for 01), actives per level and scene beside the
     yaml's capacities (the levels at their cap printed: there the
     reference truncates), one warm-up and two timed training steps at the
     yamls' batch of 4 with their own adam_onecycle and GRAD_NORM_CLIP
     (finite loss and gradient norm, overflow 0, parameters changed; 16 +
     15 K3 and 16 K4 a step for 0075, 3 K1, 25 K2, 6 K3 and 16 K4 for 01);
     every K1-K4 call of one batch-4 forward and one step against its plain
     version as in phases 2 and 6; a narrow CenterPoint (the 0075 yaml at
     16 channels, +-6.4 m) on the card and the CPU in gather mode (float32
     both sides, cuDNN's TF32 off: actives equal, every group's maps within
     1e-4 relative, decoded boxes within 1e-4 and labels equal but where a
     score lies within 1e-5 of another candidate's, printed with its
     margin) and in the yaml's pallas mode (actives equal, maps within
     phase 4's 3e-2: K3 rounds its operands to bf16); CenterHeadCLIP
     (512-wide embeddings) in place of the head (the same widened
     windows), batch 1 (finite loss with
     emb_loss > 0, decode) and VoxelBackBone8x in place of the backbone
     (batch-1 forward, 10 K3; one step, 10 + 9 K3 and 10 K4); then the
     port's CLIs as subprocesses under build/centerpoint/, each exiting 0:
     findnpropagate_torch/tools/train.py on the 0075 yaml with only
     DATA_PATH set (phase 12's nuScenes tree, 2 epochs at batch 4: a
     checkpoint per epoch, finite changing losses; the overflow its log
     reports printed), its test.py on the
     newest checkpoint (finite NDS and mAP, the recall telemetry), and
     test.py on tools/cfgs/nuscenes_models/transfusion_lidar_st.yaml with
     phase 12's self-trained checkpoint and CLASS_NAMES set to the full
     ten (the known / unknown recall and AP_B, AP_N, AR_N). Printed with
     the card's name and power limit: ms/scan at batch 1 and 4, ms/step,
     peak memory, the CLIs' wall times and, with --profile, the head's
     share of a batch-4 forward's device time (<file>.cp_<yaml>.txt);
 14. datasets — a raw Waymo tree under build/waymo/data written by the
     port's waymo_proto encoders (2 train sequences of 20 frames, 1 val of
     4; each frame one of bench.py's lidar_ring scenes of the sequence's
     40 objects, the ego moving 1 m a frame, rendered into a TOP lidar of
     64 x 2650 with two returns and a pixel pose and four side lidars of
     200 x 600 (facing, 20 m), in spawned processes; 149k-187k points a
     frame), `create_infos waymo --gt_database` as a subprocess (its gt
     database holds all three classes), then the three Waymo CenterPoint
     yamls through WaymoDataset and build_dataloader at full width
     (centerpoint.yaml: pallas, 1504 x 1504 x 41; centerpoint_4frames.yaml:
     posgather, SEQUENCE_CONFIG, 4 x 400k points; centerpoint_without_
     resnet.yaml): as phase 13, one batch-4 forward as written (its
     overflow, where it drops neighbours, and the actives per level
     beside the capacities), then with the windows widened (all levels to
     the main path's, twice that for 4 frames: WAYMO_WIDEN) forwards at
     batch 1 and 4 and training steps at batch 4 with the yamls'
     adam_onecycle (one warm-up, two timed; one for without_resnet), each
     with its launch counts and gates; a training step is gated on the
     blocks whose real targets overflow (overflow_sites: the reference's
     counter also counts the input list's padding in a strided conv's
     transposed direction), the counter's value printed; every K1-K4 call
     of one batch-4 forward and one step of the first two held against
     its plain version (K1 bit-equal); the 4-frame stack's points and time
     channel. train.py (1 epoch) and test.py on centerpoint.yaml as
     subprocesses with only DATA_PATH set (a checkpoint, finite losses,
     every LEVEL_1 / LEVEL_2 AP and APH key finite); a raw ONCE tree
     (ImageSets, per-sequence JSON, lidar_roof bins of 132k-141k points; 8
     train and 4 val frames), `create_infos once`, train.py and test.py on
     tools/cfgs/once_models/centerpoint.yaml (its AP keys finite); Lyft
     (its raw tables through `create_infos lyft`), Custom, Argo2 and
     Pandaset (info pickles written directly): one batch each through
     build_dataloader moved to the card, and the evaluation of the ground
     truth as detections (Lyft and Argo2 mAP 1; Custom's KITTI AP 0 and
     Pandaset's empty result, as in the JAX package; their simple mAP
     100/101). Printed with the card's name and power limit: ms/scan at
     batch 1 and 4, ms/step, peak memory, the loader's host ms per batch,
     create_infos' seconds per frame, the CLIs' wall seconds;
 15. anchor heads — PointPillar and SECOND at full width with
     init_random_(seed 0) weights: a raw KITTI tree under
     build/anchor/kitti/data (8 train and 4 val frames, each one of
     bench.py's lidar_ring scenes of KITTI_POINTS points with 12 Cars,
     Pedestrians and Cyclists in the camera's view, labelled through phase
     9's calibration), `create_infos kitti --gt_database`, then
     tools/cfgs/kitti_models/pointpillar.yaml and second.yaml as written
     through KittiDataset: forwards + post_process at batch 1 and 4 (no
     K1-K4 launch, finite detections; ms/scan, the decode's share, peak
     memory), a warm-up and two timed training steps at batch 4 with the
     yaml's adam_onecycle (finite loss and gradient norm, matched anchors
     > 0, parameters changed), and one second.yaml step with SUBM_IMPL:
     posgather and the main path's windows (every K1-K4 launched, each
     call against its plain version, K1 bit-equal); train.py (1 epoch) and
     test.py on both yamls as subprocesses with only DATA_PATH set, the two
     chains side by side (a checkpoint, finite losses, every KITTI AP key
     finite). tools/cfgs/lyft_models/cbgs_second_multihead.yaml through
     LyftDataset on phase 14's tree: a batch-4 forward as written (its
     overflow and actives per level beside LEVEL_CAPACITIES printed), with
     every level's windows at least the main path's a gated batch-4
     forward (6 K1 and 16 K2, overflow 0, each call against its plain
     version), and a training step, which must raise the multi-head yamls'
     code-weight error (a trait of the reference, ROADMAP.md section 3).
     On phase 12's nuScenes tree cbgs_pp_multihead.yaml (a batch-4 forward),
     centerpoint_pillar.yaml and cbgs_dyn_pp_centerpoint.yaml (a batch-4
     forward and a warm-up and a timed training step); on phase 14's Waymo
     tree pointpillar_1x.yaml (the same, 1.31 M anchors, peak memory);
 16. VoxelNeXt, VoxelNeXt2D, PillarNet and TransFusionHeadAM (VN_RUNS):
     nuScenes cbgs_voxel0075_voxelnext / voxelnext / the double flip and
     cbgs_pillar0075_res2d_centerpoint on phase 12's tree, Waymo
     voxelnext_ioubranch_large / voxelnext2d_ioubranch / pillarnet on
     phase 14's, KITTI pillarnet on phase 15's, Argo2 voxelnext and
     transfusion_lidar.yaml with TransFusionHeadAM on bench.py's
     lidar_ring scenes; init_random_(seed 0). Each yaml as written (XLA
     windowed mode: a batch-4 forward, no K1-K4 launch, its overflow
     printed), then in pallas mode (blocks of 512, as the reference's
     Pallas path requires, and the main path's windows at every level;
     the AM head on the main path's posgather backbone): forwards at the
     run's batches (K3 only; AM: K1 and K2), a warm-up and a timed
     training step at batch 4 with the yaml's optimizer (K3 and K4; AM:
     K1-K4; finite loss and gradient norm, overflow 0, parameters
     changed), and for the 3D VoxelNeXt yamls a posgather forward (K1,
     K2 at the 3x3x3 strided convs, K3 at the rest); every K1-K4 call
     of the batch-4 forwards and the timed steps held against its plain
     version (K1 bit-equal, K2-K4 within their tolerances), timed once;
     train.py and test.py on the KITTI PillarNet yaml run in phase 18.
     Printed with the card's name and power limit: ms/scan, the decode's
     share, ms/step, peak memory;
 17. the voxel two-stage detectors (TS_RUNS): SECONDNetIoU, VoxelRCNN,
     PVRCNN and PVRCNNPlusPlus on their 11 yamls at full width,
     init_random_(seed 0) — kitti second_iou / voxel_rcnn_car / pv_rcnn on
     phase 15's KITTI tree, the seven Waymo yamls on phase 14's Waymo tree
     (the 2-frame yaml through its SEQUENCE_CONFIG), once and custom
     pv_rcnn on phase 14's ONCE and Custom trees. Each yaml as written (a
     gated batch-4 forward, no K1-K4 launch, overflow 0, finite
     detections), then with SUBM_IMPL posgather, blocks of 512 and the
     main path's windows (twice them for the 2-frame stack): gated
     forwards + post_process at batch 1 and 4 (K1 and K2 launched, no K3 /
     K4, overflow 0, finite detections, peak memory), every K1 / K2 call
     of the batch-4 forward held against its plain version (K1 bit-equal;
     every K1 call of phases 16 and 17 also beside torch.searchsorted, its
     library call). On second_iou, voxel_rcnn_car, KITTI pv_rcnn and Waymo
     pv_rcnn_plusplus a warm-up and a timed training step at batch 4 in
     posgather mode with the yaml's optimizer (every K1-K4 launched, each
     call of the timed step against plain; finite loss and gradient norm,
     overflow 0, parameters changed). On the two representatives,
     voxel_rcnn_car and Waymo pv_rcnn_plusplus, each gated forward is
     followed by one timed forward (ms/scan, the decode's share), and one
     training-mode forward gives the ROI sampler's fg / bg counts, the
     proposal layer's ms with the TRAIN (up to 9000 candidates) and TEST
     NMS_CONFIG, and the keypoint sampling's ms (FPS, or sector FPS), each
     one call after the forward that ran it. Cut to fit its time (PR 17,
     for phase 18): the timed forwards and those probes on the two
     representatives only (PR 16 timed all 11 and probed the four
     trained); train.py / test.py on voxel_rcnn_car.yaml run in phase 18;
 18. Part-A2 and PointRCNN (PA_RUNS): kitti PartA2 / PartA2_free /
     pointrcnn / pointrcnn_iou on phase 15's KITTI tree, waymo PartA2 and
     once pointrcnn on phase 14's trees, at full width, init_random_(seed
     0). Each yaml as written (UNetV2 in the XLA windowed mode, or
     PointNet2MSG: a gated batch-4 forward + post_process, no K1-K4
     launch, overflow 0, finite detections, then one timed forward; KITTI
     pointrcnn at batch 1 too); the three UNetV2 yamls in posgather mode
     (blocks of 512, the main path's windows): forwards at batch 1 and 4,
     each calling K1 4 times, K2 4 (conv_out at one tap group) and K3 21
     (PA_POSGATHER_CALLS), overflow 0, every call of the batch-4 forward
     held against its plain version (K1 bit-equal). A warm-up and a timed
     training step at batch 4 with the yaml's optimizer: KITTI PartA2 in
     pallas mode (K3 and K4 only, each call of the timed step against
     plain), KITTI pointrcnn as written (no kernel); finite loss and
     gradient norm, overflow 0, parameters changed; then one
     training-mode forward of each: the ROI sampler's fg / bg, the
     proposal layer's ms with the TRAIN and TEST NMS_CONFIG (9000
     candidates), the ROI-aware (avg, max) or ROI point pooling's ms and
     PointNet2MSG's FPS ms. Then train.py (1 epoch) and test.py with only
     DATA_PATH set on phase 15's KITTI tree for kitti_models/pillarnet.yaml
     (phase 16's), voxel_rcnn_car.yaml (phase 17's) and pointrcnn.yaml (the
     first point-based data path, through sample_points), the three chains
     side by side (a checkpoint, finite losses, every KITTI AP key
     finite). Printed with the card's name and power limit: ms/scan, the
     decode's share, ms/step, peak memory, the CLIs' wall seconds;
 19. data parallelism, the checkpoint import and the demo: train.py
     --dist under `torchrun --standalone --nproc_per_node 1` on the main
     yaml over phase 12's nuScenes tree (its two train frames listed four
     times, no CBGS: two steps at BATCH_SIZE_PER_GPU 4), which must log
     world size 1 over NCCL and a global batch of 4 and leave exactly one
     checkpoint, then test.py on that checkpoint (finite NDS / mAP);
     meanwhile a random main-path model's state written in the
     reference's names and layouts (spconv v2 kernels, in_proj, kernel-1
     Conv1d weights) and imported through utils/ckpt_import.py into a
     fresh model (nothing mismatched or unmatched, every parameter and
     buffer loaded, the same eval forward bit for bit), and tools/demo.py
     over DDP_DEMO_FILES .bin files of lidar_ring scenes (finite
     detections; BEV and 3D PNGs where matplotlib imports, else a line
     saying why not), and two ranks over gloo on the one card
     (`chip_smoke.py --ddp-worker`), DDP_BATCH rows each, dropout 0,
     posgather mode, two steps: after the first, the gradients, BN
     buffers, parameters and loss against one process on the four rows
     (DDP_* tolerances; one process on rank 0's rows alone must fail
     them), the ranks identical; in the second each rank's K1-K4
     launches (TRAIN_LAUNCHES) and every call held against its plain
     version, and both steps' ms (beside train.py's process); the
     query top-k of the compared steps pinned to the one process's
     (`PinQueries`: an untrained heatmap ties at bf16 noise);
 20. a `kernels` JSON line (phases 13-18 add, per yaml, each kernel's
     calls of one batch-4 forward or of one training step, summed;
     phase 19 each rank's launches of a step), then the result line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

With --before DIR (a checkout of an earlier commit of this repo, e.g.
`git archive` of the parent unpacked under build/), that checkout's K1
(compute_positions, and its K1 kernel alone), K2, K3 and P1-P3 wrappers
are built and timed in the same process on every recorded K1, K3 and
P1-P3 call and phase 2's K2 calls (`before_*`; P1-P3 also from CUDA
graphs in turns with this one's, and their syncs and host split), its K3
in place of this one's for the pallas-mode forward and for training
steps, and its compute_positions in place of this one's for a batch-1
forward and a training step (each in turns: before, after, after,
before).

Imports nothing of jax. Without CUDA, or without the port beside it, it
exits non-zero.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import cProfile
import copy
import dataclasses
import inspect
import io
import json
import math
import multiprocessing
import os
import pickle
import pstats
import shutil
import subprocess
import sys
import time
import traceback
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12              # dense tensor-core bf16
CUDA_CORE_OPS = 67e12            # f32 / int32 outside the tensor cores
CFG_FILE = "tools/cfgs/nuscenes_models/transfusion_lidar.yaml"
# K2 compares the kernel with its plain version at the same bf16 operand
# rounding. The tensor cores add the 27*Cin f32 products of an output in
# another order (16 at a time, group by group) than the plain matmul, so
# the two are no longer bit-equal, but the error stays far below one bf16
# step (2^-8 relative): allow 1e-3 of the output's scale.
K2_RTOL = 1e-3
# K3 is held the same way (bf16 operands equal on both sides, f32 sums of
# 27*Cin products in another order). K4 sums up to 4 x 131072 targets per
# output in f32, 16 at a time on the tensor cores, per chunk of targets and
# then over the chunks, where the plain version sums sample by sample: allow
# 2e-3 of the output's scale.
K3_RTOL = 1e-3
K4_RTOL = 2e-3
# One training step in SUBM_IMPL: pallas mode against posgather mode: the
# same bf16 products, f32 sums in another tap order through 13 submanifold
# convs, batch-statistic BN and the head: the losses agree to 1e-3.
PALLAS_TRAIN_RTOL = 1e-3
PALLAS_TRAIN_LAUNCHES = {"positions": 0, "posgather_conv": 0,
                         "windowed_conv": 31, "windowed_dw": 16}
TRAIN_OPT = {"OPTIMIZER": "adam", "LR": 1e-4, "WEIGHT_DECAY": 0.0,
             "GRAD_NORM_CLIP": 10.0}
TRAIN_LAUNCHES = {"positions": 3, "posgather_conv": 25, "windowed_conv": 6,
                  "windowed_dw": 16}
SOURCES = {
    "positions": "findnpropagate_torch/ops/csrc/posgather.cu",
    "posgather_conv": "findnpropagate_torch/ops/csrc/posgather.cu",
    "windowed_conv": "findnpropagate_torch/ops/csrc/windowed_sparse.cu",
    "windowed_dw": "findnpropagate_torch/ops/csrc/windowed_sparse.cu",
    "take_along": "findnpropagate_torch/ops/csrc/gather_probes.cu",
    "onehot_gather": "findnpropagate_torch/ops/csrc/gather_probes.cu",
    "banded_gather_conv": "findnpropagate_torch/ops/csrc/gather_probes.cu",
}
REPLACES = {
    "positions": "findnpropagate_tpu/ops/pallas_posgather.py:75",
    "posgather_conv": "findnpropagate_tpu/ops/pallas_posgather.py:194",
    "windowed_conv": "findnpropagate_tpu/ops/pallas_sparse.py:39",
    "windowed_dw": "findnpropagate_tpu/ops/pallas_sparse.py:285",
    # also probe_gather.py:127, probe_gather2.py:29, probe_gather3.py:29
    "take_along": "tools/probe_gather.py:52",
    # also probe_posgather.py:203
    "onehot_gather": "tools/probe_gather.py:175",
    "banded_gather_conv": "tools/probe_posgather.py:139",
}


# findnpropagate_torch.utils.timing (CUDA-event `ms`, CUDA-graph
# `device_ms`), imported by main() once it has found the port
timing = None


def log(*a):
    print(*a, flush=True)


class Recorder:
    """Wraps a kernel wrapper of the port's ops and keeps a copy of the
    arguments of every call, but of none made while `skip()` is true."""

    def __init__(self, module, name, torch, skip=lambda: False, calls=None):
        self.module, self.name, self.torch = module, name, torch
        self.orig = getattr(module, name)
        self.calls = [] if calls is None else calls
        self.skip = skip

    def __enter__(self):
        def rec(*args, **kw):
            if self.skip():
                return self.orig(*args, **kw)
            clone = lambda x: x.clone() if isinstance(  # noqa: E731
                x, self.torch.Tensor) else x
            self.calls.append(([clone(a) for a in args],
                               {k: clone(v) for k, v in kw.items()}))
            return self.orig(*args, **kw)
        setattr(self.module, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


@contextlib.contextmanager
def record_positions(torch, tp):
    """Records every compute_positions call, made through the posgather
    module or through the backbone's own import of it, in call order."""
    import importlib

    bb = importlib.import_module(
        "findnpropagate_torch.models.backbones_3d.spconv_backbone")
    calls = []
    with Recorder(tp, "compute_positions", torch, calls=calls), \
            Recorder(bb, "compute_positions", torch, calls=calls):
        yield calls


def window_union(lo, live, window):
    """The number of source ids that the windows [lo, lo + window) of the
    live blocks cover together, summed over the samples: neighbouring
    blocks' windows overlap, and an id read once serves them all."""
    n = 0
    for starts, keep in zip(lo.cpu().numpy(), live.cpu().numpy() != 0):
        s = np.sort(starts[keep].astype(np.int64))
        if s.size:
            n += int(np.minimum(np.diff(s), window).sum()) + window
    return n


def positions_bound(lp, tgt, span):
    """K1 as one launch per level: the targets read once, the source ids
    under the live blocks' windows once (`window_union`), pos, the three
    per-block arrays and the overflow counts written once; a search of
    log2(span) steps per (target of a live block, group)."""
    b, vt = tgt.shape
    g_n, nb = lp.gdeltas.shape[0], lp.lo.shape[1]
    live = int(lp.has_real.sum())
    nbytes = 4 * (tgt.numel() + window_union(lp.lo, lp.has_real, lp.window)
                  + b * g_n * vt + 3 * b * nb) + 8 * b
    ops = live * lp.block * g_n * math.ceil(math.log2(span + 1))
    return nbytes / HBM_BYTES_PER_S, ops / CUDA_CORE_OPS


def conv_bound(tp, args, kw):
    (src, feats, tgt, pos, lo, has_real, gdeltas, w_flat, block,
     window) = args
    hits = sum(int(found.sum()) for _, found in tp.neighbour_probes(
        src, tgt, pos, lo, has_real, gdeltas, block, window))
    cin, cout = feats.shape[2], w_flat.shape[1]
    nbytes = (4 * (src.numel() + tgt.numel() + pos.numel() + lo.numel()
                   + has_real.numel() + feats.numel())
              + 2 * w_flat.numel() + 4 * tgt.numel() * cout
              + (8 * cout if kw.get("scale") is not None else 0))
    flops = 2 * cin * cout * hits
    return nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS, hits


def bound_entry(t_bytes, t_ops):
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def plain_kw(kw):
    """A recorded K3 call's keywords without the kernel's own (the
    host-side group centres), as the plain version takes them."""
    return {k: v for k, v in kw.items() if k != "centres"}


def with_plan(ws, plan, fn):
    """fn() with K3's plan forced to `plan` (stages, resident, staging)."""
    with Swap(ws, "conv_plan", lambda *a: plan):
        return fn()


def k3_err(torch, out, ref, label):
    """(max abs error, tolerance) of a K3 output against plain; raises
    beyond K3_RTOL of the output's scale or on a non-finite value."""
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    tol = K3_RTOL * max(float(ref.abs().max()), 1e-3)
    if not (err <= tol and bool(torch.isfinite(out).all())):
        raise AssertionError(f"{label}: K3 err {err} > {tol}")
    return err, tol


def check_k3(torch, ws, label, call):
    """`call` (one windowed_conv) with its K3 launch recorded and held
    against the plain version: out, ref, overflow, the recorded args and
    kw, err, tol."""
    with Recorder(ws, "conv_kernel", torch) as rec:
        out, ovf = call()
    (args, kw), = rec.calls
    ref = ws.windowed_conv_plain(*args, **plain_kw(kw))
    err, tol = k3_err(torch, out, ref, label)
    return types.SimpleNamespace(out=out, ref=ref, ovf=int(ovf.sum()),
                                 args=args, kw=kw, err=err, tol=tol)


def corner_scene(torch, so, rng, shape, n_active, cap, batch, cin):
    """`batch` samples of n_active random cells of a small grid (all of
    them: a dense cube), sorted by id and padded to `cap` rows with
    sentinels; features are zero on the padding. Returns (ids, feats,
    coords, valid), coords and valid in the cells' drawn order."""
    nz, ny, nx = shape
    coords = np.full((batch, cap, 3), -1, np.int32)
    for i in range(batch):
        lin = rng.choice(nz * ny * nx, n_active, replace=False)
        coords[i, :n_active] = np.stack(
            [lin % nz, (lin // nz) % ny, lin // (nz * ny)], 1)
    coords = torch.from_numpy(coords).cuda()
    valid = torch.arange(cap, device="cuda")[None, :].expand(batch, -1) \
        < n_active
    ids, order = torch.sort(so.yxz_linear_ids(coords, valid, shape), dim=1)
    feats = torch.from_numpy(rng.standard_normal(
        (batch, cap, cin)).astype("float32")).cuda()
    feats = feats * (ids < so.yxz_sentinel_start(shape))[..., None]
    return ids.contiguous(), feats, coords, valid


CORNERS = [
    # name, grid, actives, rows, batch, Cin, Cout, window, epilogue
    ("dense cube, 27 hits", (8, 16, 16), 2048, 2048, 1, 64, 128, 4096, True),
    ("window too small", (9, 24, 24), 2000, 2048, 1, 16, 16, 512, True),
    ("sentinel blocks at the end", (9, 40, 40), 1500, 4096, 4, 32, 64, 4096,
     True),
    ("dead block in the middle", (9, 40, 40), 3000, 4096, 1, 32, 32, 4096,
     False),
    ("Cout 10", (9, 40, 40), 1800, 2048, 1, 16, 10, 4096, False),
    ("Cout 3, batch 4", (9, 40, 40), 1800, 2048, 4, 64, 3, 4096, True),
    ("Cin 4", (9, 40, 40), 1800, 2048, 1, 4, 16, 4096, False),
]


def corner_phase(torch, tp, ws, so, block=1024):
    """K2, K3 and K4 against their plain versions on synthetic cases (numpy
    seed 0) that the recorded launches of the paths do not reach."""
    rng = np.random.RandomState(0)
    rows = []
    for name, shape, n, cap, b, cin, cout, window, epi in CORNERS:
        ids, feats, _, _ = corner_scene(torch, so, rng, shape, n, cap, b,
                                        cin)
        deltas = so.yxz_offset_deltas((3, 3, 3), shape)
        sent = so.yxz_sentinel_start(shape)
        w = torch.from_numpy(rng.standard_normal(
            (27, cin, cout)).astype("float32") * 0.1).cuda()
        kw = {}
        if epi:
            kw = dict(scale=torch.from_numpy(rng.uniform(
                0.5, 1.5, cout).astype("float32")).cuda(),
                shift=torch.from_numpy(rng.standard_normal(
                    cout).astype("float32")).cuda(), relu=True)
        lp = check_level(torch, tp, (ids, ids, deltas),
                         dict(block=block, window=window,
                              sentinel_start=sent), f"corner {name}")[0]
        if name == "dead block in the middle":
            hr = lp.has_real.clone()
            hr[:, 1] = 0
            lp = dataclasses.replace(lp, has_real=hr)
        with Recorder(tp, "gather_conv", torch) as rec:
            out = tp.posgather_conv(ids, feats, ids, w, lp,
                                    sentinel_start=sent, **kw)
        (args, ckw), = rec.calls
        ref = tp.posgather_conv_plain(*args, **ckw)[..., :cout]
        torch.cuda.synchronize()
        err2 = float((out - ref).abs().max())
        tol2 = K2_RTOL * max(float(ref.abs().max()), 1e-3)
        hits = torch.stack([f for _, f in tp.neighbour_probes(
            args[0], *args[2:7], *args[8:10])]).sum(dim=0).sum(dim=1)
        ovf = int(lp.overflow.sum())
        dead = int((lp.has_real == 0).sum())
        if not (err2 <= tol2 and bool(torch.isfinite(out).all())):
            raise AssertionError(f"corner {name}: K2 err {err2} > {tol2}")
        if name.startswith("dense cube") and int(hits.max()) != 27:
            raise AssertionError(f"corner {name}: at most {int(hits.max())} "
                                 "of 27 neighbours hit")
        if (name == "window too small") != (ovf > 0):
            raise AssertionError(f"corner {name}: overflow {ovf}")
        if name in ("sentinel blocks at the end",
                    "dead block in the middle") and not (
                dead > 0 and bool((out.reshape(
                    b, -1, block, cout)[lp.has_real == 0] == 0).all())):
            raise AssertionError(f"corner {name}: {dead} dead blocks, or "
                                 "their rows are not zero")

        g = torch.from_numpy(rng.standard_normal(
            (b, cap, cout)).astype("float32")).cuda()
        with Recorder(ws, "dw_kernel", torch) as rec:
            dw = ws.windowed_dw(ids, feats, ids, g, deltas, block=block,
                                window=window)
        (args, ckw), = rec.calls
        ref = ws.windowed_dw_plain(*args,
                                   compute_dtype=ckw["compute_dtype"])
        torch.cuda.synchronize()
        err4 = float((dw - ref).abs().max())
        tol4 = K4_RTOL * max(float(ref.abs().max()), 1e-3)
        if not (tuple(dw.shape) == (27, cin, cout) and err4 <= tol4
                and bool(torch.isfinite(dw).all())):
            raise AssertionError(f"corner {name}: K4 err {err4} > {tol4}")
        if not torch.equal(dw, ws.dw_kernel(*args, **ckw)):
            raise AssertionError(f"corner {name}: K4 differs between runs")

        k3 = check_k3(torch, ws, f"corner {name}", lambda: ws.windowed_conv(
            ids, feats, ids, w, deltas, block=block, window=window,
            sentinel_start=sent, **kw))
        if k3.ovf != ovf:
            raise AssertionError(f"corner {name}: K3 overflow {k3.ovf}")
        if epi and not bool((k3.out[ids >= sent] == 0).all()):
            raise AssertionError(f"corner {name}: K3 sentinel rows not 0")
        rows.append({"case": name, "batch": b, "cin": cin, "cout": cout,
                     "overflow": ovf, "dead_blocks": dead,
                     "max_hits": int(hits.max()), "k2_err": err2,
                     "k2_tol": tol2, "k3_err": k3.err, "k3_tol": k3.tol,
                     "k4_err": err4, "k4_tol": tol4})
        log(f"corner {name:28s} batch {b} {cin}->{cout} overflow {ovf} "
            f"dead blocks {dead} max hits {int(hits.max())}: K2 err "
            f"{err2:.3g} (tol {tol2:.3g}), K3 err {k3.err:.3g} (tol "
            f"{k3.tol:.3g}), K4 err {err4:.3g} (tol {tol4:.3g})")
    return rows + k3_corners(torch, ws, so, rng, block) \
        + wide_corners(torch, tp, ws, so, block) \
        + k1_corners(torch, tp, so, block)


def k2_err(torch, out, ref, label):
    """(max abs error, tolerance) of a K2 output against plain; raises
    beyond K2_RTOL of the output's scale or on a non-finite value."""
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    tol = K2_RTOL * max(float(ref.abs().max()), 1e-3)
    if not (err <= tol and bool(torch.isfinite(out).all())):
        raise AssertionError(f"{label}: K2 err {err} > {tol}")
    return err, tol


def k4_check(torch, ws, label, call):
    """`call` (one windowed_dw) with its K4 launches recorded, held
    against the plain version (K4_RTOL) and rerun (the same bits)."""
    with Recorder(ws, "dw_kernel", torch) as rec:
        dw = call()
    (args, ckw), = rec.calls
    ref = ws.windowed_dw_plain(*args, compute_dtype=ckw["compute_dtype"])
    torch.cuda.synchronize()
    err = float((dw - ref).abs().max())
    tol = K4_RTOL * max(float(ref.abs().max()), 1e-3)
    if not (err <= tol and bool(torch.isfinite(dw).all())):
        raise AssertionError(f"{label}: K4 err {err} > {tol}")
    if not torch.equal(dw, ws.dw_kernel(*args, **ckw)):
        raise AssertionError(f"{label}: K4 differs between runs")
    return err, tol


def strided_level(so, coords, valid, shape, kernel, stride, padding, cap):
    """The output level of a strided conv over (coords, valid) and its
    base ids and deltas in the input id space."""
    out_shape = tuple((n + 2 * p - k) // s + 1 for n, k, s, p in zip(
        shape, kernel, stride, padding))
    oi, oc, ov = so.win_downsample(coords, valid, shape, out_shape, cap,
                                   kernel_size=kernel, stride=stride,
                                   padding=padding)
    base = so.strided_base_ids(oc, ov, stride, shape, out_shape)
    return base, so.strided_deltas(kernel, stride, padding, shape)


WIDE_CORNERS = [
    # name, grid, kernel, stride, padding, actives, rows, batch, Cin, Cout,
    # window
    ("2D (1,3,3) subm, S=1", (1, 96, 96), (1, 3, 3), None, None, 4000,
     4096, 2, 32, 64, 2048),
    ("2D (1,3,3) stride (1,2,2), S=1", (1, 96, 96), (1, 3, 3), (1, 2, 2),
     (0, 1, 1), 4000, 4096, 2, 64, 128, 4096),
    ("5x5x5 stride 2, S=5", (9, 64, 64), (5, 5, 5), (2, 2, 2), (2, 2, 2),
     6000, 8192, 2, 32, 64, 8192),
    ("5x5x5 stride 2, S=5, 64->128", (9, 48, 48), (5, 5, 5), (2, 2, 2),
     (2, 2, 2), 4000, 4096, 1, 64, 128, 8192),
    ("3x3x3 stride 2, 128->256", (9, 48, 48), (3, 3, 3), (2, 2, 2),
     (1, 1, 1), 4000, 4096, 2, 128, 256, 6144),
    ("3x3x3 subm, 256->256", (9, 40, 40), (3, 3, 3), None, None, 3000,
     4096, 2, 256, 256, 4096),
    # UNetV2's conv_out: a (3, 1, 1) kernel, one tap group, stride (2, 1,
    # 1) with no padding; its merge convs over concatenated channels
    ("(3,1,1) stride (2,1,1), G=1", (5, 48, 48), (3, 1, 1), (2, 1, 1),
     (0, 0, 0), 4000, 4096, 2, 64, 128, 4096),
    ("3x3x3 subm, 128->64 (merge)", (9, 40, 40), (3, 3, 3), None, None,
     3000, 4096, 2, 128, 64, 4096),
]


def wide_corners(torch, tp, ws, so, block):
    """K3 and K4 at the tap groups and K2, K3 and K4 at the channel
    counts that the VoxelNeXt / PillarNet paths add (numpy seed 2): groups
    of one tap on a 2D level, (1, 3, 3) kernels, submanifold and stride
    (1, 2, 2); groups of five of a 5x5x5 stride-2 conv; 128 -> 256 and
    256 -> 256 (K2 where the kernel is 3 deep, K3 also in the transposed
    direction, whose transposed 5x5x5 and 256 -> 128 convs need Cin
    slices); and UNetV2's: its (3, 1, 1) conv_out, a single tap group at
    K1 / K2 as well, and a 128 -> 64 merge conv. Each against its plain
    version; the launches per call printed (channel slices)."""
    from findnpropagate_torch.ops.posgather import (
        flip_transpose_weights, tap_groups)

    rng = np.random.RandomState(2)
    rows = []
    for (name, shape, kernel, stride, padding, n, cap, b, cin, cout,
         window) in WIDE_CORNERS:
        ids, feats, coords, valid = corner_scene(torch, so, rng, shape, n,
                                                 cap, b, cin)
        k = int(np.prod(kernel))
        w = torch.from_numpy(rng.standard_normal(
            (k, cin, cout)).astype("float32") * (1.0 / math.sqrt(
                k * cin))).cuda()
        if stride is None:
            tgt, deltas = ids, so.yxz_offset_deltas(kernel, shape)
            sent = so.yxz_sentinel_start(shape)
        else:
            tgt, deltas = strided_level(so, coords, valid, shape, kernel,
                                        stride, padding, cap)
            sent = so.strided_sentinel_start(shape)
        taps = tap_groups(deltas)[1]
        epi = dict(scale=torch.from_numpy(rng.uniform(
            0.5, 1.5, cout).astype("float32")).cuda(),
            shift=torch.from_numpy(rng.standard_normal(
                cout).astype("float32")).cuda(), relu=True)
        row = {"case": name, "batch": b, "cin": cin, "cout": cout,
               "taps": taps}
        ws.reset_launches()
        k3 = check_k3(torch, ws, name, lambda: ws.windowed_conv(
            ids, feats, tgt, w, deltas, block=block, window=window,
            sentinel_start=sent, **epi))
        row.update(k3_err=k3.err, k3_tol=k3.tol, overflow=k3.ovf,
                   k3_launches=ws.LAUNCHES["windowed_conv"])
        g = torch.from_numpy(rng.standard_normal(
            (b, tgt.shape[1], cout)).astype("float32")).cuda()
        ws.reset_launches()
        err4, tol4 = k4_check(torch, ws, name, lambda: ws.windowed_dw(
            ids, feats, tgt, g, deltas, block=block, window=window))
        row.update(k4_err=err4, k4_tol=tol4,
                   k4_launches=ws.LAUNCHES["windowed_dw"])
        ws.reset_launches()
        kt = check_k3(torch, ws, f"{name} transposed",
                      lambda: ws.windowed_conv(
                          tgt, g, ids, flip_transpose_weights(w),
                          np.ascontiguousarray(-deltas[::-1]), block=block,
                          window=window))
        row.update(k3t_err=kt.err, k3t_tol=kt.tol,
                   k3t_launches=ws.LAUNCHES["windowed_conv"])
        if kernel[0] == 3:
            lp = check_level(torch, tp, (ids, tgt, deltas),
                             dict(block=block, window=window,
                                  sentinel_start=sent), f"corner {name}")[0]
            tp.reset_launches()
            with Recorder(tp, "gather_conv", torch) as rec:
                out = tp.posgather_conv(ids, feats, tgt, w, lp,
                                        sentinel_start=sent, **epi)
            (args, ckw), = rec.calls
            err2, tol2 = k2_err(torch, out, tp.posgather_conv_plain(
                *args, **ckw)[..., :cout], name)
            row.update(k2_err=err2, k2_tol=tol2,
                       k2_launches=tp.LAUNCHES["posgather_conv"])
        if k3.ovf or kt.ovf:
            raise AssertionError(f"corner {name}: overflow {k3.ovf} "
                                 f"{kt.ovf}")
        rows.append(row)
        log(f"corner {name:32s} batch {b} {cin}->{cout} taps {taps}: "
            + ", ".join(f"{key} {val:.3g}" if isinstance(val, float)
                        else f"{key} {val}" for key, val in row.items()
                        if key not in ("case", "batch", "cin", "cout",
                                       "taps")))
    ws.reset_launches()
    tp.reset_launches()
    return rows


K1_CORNERS = [
    # name, grid, actives, rows, batch, window, tap window, sentinel
    ("tap window, tap overflow", (9, 40, 40), 3000, 4096, 2, 4096, 256,
     True),
    ("window beyond the staged budget", (9, 64, 64), 24000, 24576, 1,
     16384, None, True),
    ("tap window beyond the staged budget", (9, 64, 64), 24000, 24576, 1,
     16384, 1024, True),
    ("no sentinel", (9, 40, 40), 1500, 4096, 2, 1024, None, False),
]


def k1_corners(torch, tp, so, block):
    """K1 against compute_positions_plain (`check_level`) where the
    recorded launches and the conv corners do not reach: tap windows (with
    tap-window overflow), windows too large to stage in shared memory, and
    no sentinel (every block live, its last target the block's last id).
    The conv corners above also hold K1 where the union window overflows
    and on blocks of sentinels alone. Scenes from numpy seed 1."""
    rng = np.random.RandomState(1)
    rows = []
    for name, shape, n, cap, b, window, tap, has_sent in K1_CORNERS:
        ids = corner_scene(torch, so, rng, shape, n, cap, b, 16)[0]
        deltas = so.yxz_offset_deltas((3, 3, 3), shape)
        kw = dict(block=block, window=window, tap_window=tap,
                  sentinel_start=so.yxz_sentinel_start(shape)
                  if has_sent else None)
        lp = check_level(torch, tp, (ids, ids, deltas), kw,
                         f"K1 corner {name}")[0]
        ovf, dead = int(lp.overflow.sum()), int((lp.has_real == 0).sum())
        if name.startswith("tap window") and not ovf > 0:
            raise AssertionError(f"K1 corner {name}: no tap overflow")
        rows.append({"case": name, "batch": b, "window": lp.window,
                     "tap_window": tap, "overflow": ovf,
                     "dead_blocks": dead, "k1_equal": True})
        log(f"K1 corner {name:36s} batch {b} window {lp.window} tap {tap} "
            f"overflow {ovf} dead blocks {dead}: equal to plain")
    return rows


def k3_corners(torch, ws, so, rng, block):
    """K3 alone: (1) the transposed direction of a stride-2 conv at 128 ->
    64 channels (the 64->128 conv's d_feats, source list the coarse base
    ids, the L2->L3 strided window: one stage, the window staged in shared
    memory or searched in device memory); (2) epilogue rows of real
    targets without any neighbour, which must read relu(shift)."""
    from findnpropagate_torch.ops.posgather import flip_transpose_weights

    rows = []
    shape, b = (9, 64, 64), 4
    ids, _, coords, valid = corner_scene(torch, so, rng, shape, 6000, 8192,
                                         b, 16)
    out_shape = tuple((n + 2 - 3) // 2 + 1 for n in shape)
    _, oc, ov = so.win_downsample(coords, valid, shape, out_shape, 8192)
    base = so.strided_base_ids(oc, ov, (2, 2, 2), shape, out_shape)
    deltas = so.strided_deltas((3, 3, 3), (2, 2, 2), (1, 1, 1), shape)
    g = torch.from_numpy(rng.standard_normal(
        (b, base.shape[1], 128)).astype("float32")).cuda()
    w = torch.from_numpy(rng.standard_normal(
        (27, 64, 128)).astype("float32") * 0.05).cuda()
    wt = flip_transpose_weights(w)
    tdeltas = np.ascontiguousarray(-deltas[::-1])
    k3 = check_k3(torch, ws, "transposed 128->64", lambda: ws.windowed_conv(
        base, g, ids, wt, tdeltas, block=block, window=6144))
    if k3.ovf:
        raise AssertionError(f"transposed 128->64: overflow {k3.ovf}")
    src, _, tgt, lo, dl, _, _, window = k3.args
    hits = windowed_hits(torch, ws, src, tgt, lo, dl, block, window)
    plan = ws.conv_plan(128, 64, window)
    other = plan[:2] + (not plan[2],)
    err, tol = k3_err(torch, with_plan(ws, other, lambda: ws.conv_kernel(
        *k3.args, **k3.kw)), k3.ref, f"transposed 128->64 plan {other}")
    for p, e, t in ((plan, k3.err, k3.tol), (other, err, tol)):
        rows.append({"case": "transposed 128->64", "plan": list(p),
                     "batch": b, "window": window, "hits": hits,
                     "k3_err": e, "k3_tol": t})
        log(f"corner transposed 128->64 batch {b} window {window} plan "
            f"{p} hits {hits}: K3 err {e:.3g} (tol {t:.3g})")

    shape = (9, 40, 40)
    sent = so.yxz_sentinel_start(shape)
    ids, feats, _, _ = corner_scene(torch, so, rng, shape, 3000, 4096, 1, 32)
    keep = ids < ids[:, :1500].max()       # sources: the lower half of ids
    src = torch.cat([ids[keep], sent + torch.arange(
        int((~keep).sum()), device="cuda", dtype=ids.dtype)])[None]
    sfeats = torch.cat([feats[keep], feats.new_zeros(
        int((~keep).sum()), 32)])[None]
    w = torch.from_numpy(rng.standard_normal(
        (27, 32, 32)).astype("float32") * 0.1).cuda()
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, 32).astype(
        "float32")).cuda()
    shift = torch.from_numpy(rng.standard_normal(32).astype(
        "float32")).cuda()
    deltas = so.yxz_offset_deltas((3, 3, 3), shape)
    k3 = check_k3(
        torch, ws, "targets without neighbours", lambda: ws.windowed_conv(
            src, sfeats, ids, w, deltas, block=block, window=4096,
            sentinel_start=sent, scale=scale, shift=shift, relu=True))
    src, _, tgt, lo, dl, _, _, window = k3.args
    lonely = (ws.neighbour_rows(src, tgt, lo, dl, block, window)[1].sum(
        dim=1) == 0) & (ids < sent)
    n = int(lonely.sum())
    if k3.ovf or n < 100 or not torch.equal(
            k3.out[lonely], torch.relu(shift).expand(n, -1)):
        raise AssertionError(f"targets without neighbours: {n} rows, not "
                             "relu(shift), or overflow")
    rows.append({"case": "epilogue, targets without neighbours",
                 "lonely_rows": n, "k3_err": k3.err, "k3_tol": k3.tol})
    log(f"corner epilogue rows without neighbours: {n} rows = relu(shift); "
        f"K3 err {k3.err:.3g} (tol {k3.tol:.3g})")
    return rows


def k1_library(torch, src, tgt, lp):
    """The library call that computes K1's ranks: torch.searchsorted of all
    G*Vt queries (target + group centre) in each sample's sorted source ids,
    in one call. Its global rank is K1's rank (counted from the block's
    window start) plus that start wherever the id is found; checked there.
    Returns the call."""
    b, g_n = tgt.shape[0], lp.gdeltas.shape[0]
    q = (tgt[:, None, :] + lp.gdeltas[None, :, None]).reshape(b, -1)
    hit = lp.pos >= 0
    start = lp.lo.long()[:, None, :, None].expand(
        b, g_n, lp.lo.shape[1], lp.block).reshape(lp.pos.shape)
    rank = torch.searchsorted(src, q).reshape(lp.pos.shape)
    if not torch.equal(rank[hit], lp.pos.long()[hit] + start[hit]):
        raise AssertionError("K1: torch.searchsorted's ranks differ from "
                             "K1's where the id is found")
    return lambda: torch.searchsorted(src, q)


def runtime_calls(torch, fn, reps=5):
    """(stream or device syncs, host-to-device copies, kernel launches) per
    call of fn that torch.profiler records over `reps` calls after a warm
    call, less what it records around as many calls of nothing (the
    profiler's own synchronisation)."""
    from torch.profiler import ProfilerActivity, profile

    def count(f):
        f()
        torch.cuda.synchronize()
        done = torch.cuda.Event()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                f()
            done.record()
            done.synchronize()
        counts = [0, 0, 0]
        for e in prof.key_averages():
            counts[0] += e.count * ("StreamSynchronize" in e.key
                                    or "DeviceSynchronize" in e.key)
            counts[1] += e.count * ("HtoD" in e.key or "cudaMemcpy" in e.key)
            counts[2] += e.count * ("LaunchKernel" in e.key)
        return counts

    base = count(lambda: None)
    return tuple((c - b) / reps for c, b in zip(count(fn), base))


LP_FIELDS = ("lo", "base", "pos", "has_real", "overflow")


def check_level(torch, tp, args, kw, label):
    """K1 (one launch: prelude and search) against compute_positions_plain
    on the card, all five integer fields bit for bit, and the same kernel
    with that prelude given (`positions`; where a tap window is set, with
    tap offsets drawn at random, multiples of 128 in [0, window - span],
    torch seed 0) against positions_plain. Returns both LevelPositions and
    the given-prelude call."""
    lp = tp.compute_positions(*args, **kw)
    ref = tp.compute_positions_plain(*args, **kw)
    torch.cuda.synchronize()
    for f in LP_FIELDS:
        a, r = getattr(lp, f), getattr(ref, f)
        if a.shape != r.shape or not torch.equal(a.long(), r.long()):
            raise AssertionError(f"{label}: K1 {f} != plain")
    src = tp._pad_src(args[0])[0]
    tap = kw.get("tap_window")
    use_tap = tap is not None and tap < ref.window
    b, nb = ref.lo.shape
    shape = (b, nb, ref.gdeltas.shape[0])
    tap_lo = torch.zeros(shape, dtype=torch.int32)
    if use_tap:
        tap_lo = 128 * torch.randint(
            (ref.window - tap) // 128 + 1, shape, dtype=torch.int32,
            generator=torch.Generator().manual_seed(0))
    given = (src, args[1].contiguous(), ref.lo, tap_lo.to(src.device),
             ref.has_real, ref.gdeltas, ref.block,
             tap if use_tap else ref.window, use_tap)
    if not torch.equal(tp.positions(*given), tp.positions_plain(*given)):
        raise AssertionError(f"{label}: K1 with the prelude given != plain")
    return lp, ref, given


def host_us(torch, fn, n=500):
    """Host microseconds per call of fn over n calls (after a warm call),
    on the host's clock, the device synchronised before and after."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def host_split(torch, fn, n=200, least_us=0.5):
    """Where a call's host time goes: host_us of fn, and the microseconds
    per call that cProfile charges to each function it runs (own time; the
    Python function that makes a ctypes call is charged with it, and
    cProfile's own cost is in every entry), those of at least `least_us`."""
    split = {"call": host_us(torch, fn)}
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(n):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    for (path, line, name), st in pstats.Stats(prof).stats.items():
        us = st[2] / n * 1e6
        if us >= least_us and name != "<lambda>":
            where = "" if path == "~" else f"{Path(path).name}:"
            split[where + name] = split.get(where + name, 0.0) + us
    return split


def check_positions(torch, tp, pos_calls, label="", before=None):
    """K1 vs plain, bit for bit, on every recorded compute_positions call
    (`check_level`), beside the library call (`k1_library`); per-call
    rows. The first call also counts the stream syncs and host-to-device
    copies per call (`runtime_calls`); `before`: the earlier checkout's
    compute_positions and K1 timed on the same arguments."""
    rows = []
    for i, (args, kw) in enumerate(pos_calls):
        lp, ref, given = check_level(torch, tp, args, kw,
                                     f"{label}K1 call {i}")
        tap = kw.get("tap_window")
        span = tap if tap is not None and tap < lp.window else lp.window
        library = k1_library(torch, given[0], given[1], ref)
        bound_ms, bound_by = bound_entry(*positions_bound(ref, args[1],
                                                          span))
        call = lambda: tp.compute_positions(*args, **kw)  # noqa: E731
        row = {
            "name": "positions", "call": i, "batch": args[1].shape[0],
            "vt": args[1].shape[1], "vs": given[0].shape[1], "span": span,
            "tap": span != lp.window, "window": lp.window,
            "overflow": int(ref.overflow.sum()),
            "dead_blocks": int((ref.has_real == 0).sum()), "max_abs_err": 0,
            "ms": timing.ms(call, 20),
            "device_ms": timing.device_ms(call, 20),
            "given_prelude_device_ms": timing.device_ms(
                lambda: tp.positions(*given), 20),
            "plain_ms": timing.ms(lambda: tp.compute_positions_plain(
                *args, **kw), 3),
            "library_ms": timing.ms(library, 20),
            "library_device_ms": timing.device_ms(library, 20),
            "bound_ms": bound_ms, "bound_by": bound_by}
        with Swap(tp, "STAGE_WINDOW", False):
            same = all(torch.equal(getattr(tp.compute_positions(*args, **kw),
                                           f).long(), getattr(ref, f).long())
                       for f in LP_FIELDS)
            if not same:
                raise AssertionError(f"{label}K1 call {i}: unstaged != plain")
            row["unstaged_device_ms"] = timing.device_ms(call, 20)
        if i == 0:
            row["host_us"] = host_split(torch, call)
            row["syncs"], row["h2d_copies"], row["launches_seen"] = \
                runtime_calls(torch, call)
            if row["syncs"] or row["h2d_copies"]:
                raise AssertionError(
                    f"{label}K1: compute_positions synced {row['syncs']} "
                    f"times and copied {row['h2d_copies']} times to the "
                    "device per call")
        if before is not None:
            row["before_ms"] = timing.ms(
                lambda: before.compute_positions(*args, **kw), 20)
            row["before_kernel_device_ms"] = timing.device_ms(
                lambda: before.positions(*given), 20)
            if i == 0:
                row["before_syncs"], row["before_h2d_copies"], _ = \
                    runtime_calls(torch, lambda: before.compute_positions(
                        *args, **kw))
                row["before_host_us"] = host_split(
                    torch, lambda: before.compute_positions(*args, **kw))
        rows.append(row)
        del lp, ref, given
    return rows


def log_positions_rows(rows, label=""):
    for r in rows:
        extra = "".join(f" {k} {r[k]:.4f}" for k in (
            "unstaged_device_ms", "before_ms", "before_kernel_device_ms")
            if k in r)
        syncs = (f" syncs {r['syncs']} h2d {r['h2d_copies']} launches "
                 f"{r['launches_seen']}" if "syncs" in r else "") + (
            f" (before: syncs {r['before_syncs']} h2d "
            f"{r['before_h2d_copies']})" if "before_syncs" in r else "")
        log(f"{label}positions call {r['call']:2d} batch {r['batch']} "
            f"vt={r['vt']} span={r['span']} ovf {r['overflow']} dead "
            f"{r['dead_blocks']}: ms {r['ms']:.4f} (device "
            f"{r['device_ms']:.4f}, prelude given "
            f"{r['given_prelude_device_ms']:.4f})  plain "
            f"{r['plain_ms']:.3f}  library {r['library_ms']:.4f} (device "
            f"{r['library_device_ms']:.4f})  bound {r['bound_ms']:.4f} "
            f"({r['bound_by']}){extra}{syncs}" + "".join(
                f"  {k} " + " ".join(f"{f} {v:.1f}" for f, v in r[k].items())
                for k in ("host_us", "before_host_us") if k in r))


def check_kernels(torch, tp, pos_calls, conv_calls, before=None):
    """Kernel vs plain on every recorded call; returns per-call rows
    (with `before`, K1 and K2 also timed through the earlier checkout's)."""
    rows = check_positions(torch, tp, pos_calls, before=before)
    for i, (args, kw) in enumerate(conv_calls):
        out = tp.gather_conv(*args, **kw)
        ref = tp.posgather_conv_plain(*args, **kw)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        tol = K2_RTOL * max(float(ref.abs().max()), 1e-3)
        if not (err <= tol and bool(torch.isfinite(out).all())):
            raise AssertionError(f"K2 call {i}: max err {err} > {tol}")
        t_b, t_o, hits = conv_bound(tp, args, kw)
        bound_ms, bound_by = bound_entry(t_b, t_o)
        rows.append({
            "name": "posgather_conv", "call": i, "vt": args[2].shape[1],
            "vs": args[0].shape[1], "cin": args[1].shape[2],
            "cout": args[7].shape[1], "window": args[9],
            "epilogue": kw.get("scale") is not None, "hits": hits,
            "max_abs_err": err, "tolerance": tol,
            "ms": timing.ms(lambda: tp.gather_conv(*args, **kw), 10),
            "device_ms": timing.device_ms(
                lambda: tp.gather_conv(*args, **kw), 10),
            "plain_ms": timing.ms(lambda: tp.posgather_conv_plain(
                *args, **kw), 3),
            "bound_ms": bound_ms, "bound_by": bound_by})
        if before is not None:
            rows[-1]["before_device_ms"] = timing.device_ms(
                lambda: before.gather_conv(*args, **kw), 10)
    return rows


def forward_ms(torch, det, batch, reps):
    """(median, all) ms of `reps` forward + post_process, after 2 warm-up
    runs, each timed by CUDA events and synchronised."""
    times = []
    for i in range(reps + 2):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        det.post_process(det(batch))
        t1.record()
        torch.cuda.synchronize()
        if i >= 2:
            times.append(t0.elapsed_time(t1))
    return sorted(times)[len(times) // 2], times


def run_main_path(torch, det, tp, batch, b, reps):
    tp.reset_launches()
    out = det(batch)
    dets = det.post_process(out)
    torch.cuda.synchronize()
    launches = dict(tp.LAUNCHES)
    if launches != {"positions": 6, "posgather_conv": 16}:
        raise AssertionError(f"batch {b}: launches {launches}, want 6/16")
    ovf = int(out["sparse_window_overflow"])
    if ovf != 0:
        raise AssertionError(f"batch {b}: sparse_window_overflow {ovf}")
    for name in ("boxes", "scores"):
        t = getattr(dets, name)
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"batch {b}: non-finite {name}")
    if tuple(dets.boxes.shape) != (b, 200, 9):
        raise AssertionError(f"batch {b}: boxes {tuple(dets.boxes.shape)}")
    active = [int(c) // b for c in out["sparse_active_counts"]]
    torch.cuda.reset_peak_memory_stats()
    med, times = forward_ms(torch, det, batch, reps)
    return {"batch": b, "launches_per_forward": launches,
            "ms_per_batch": med, "ms_per_scan": med / b,
            "scans_per_s": 1e3 * b / med, "times_ms": times,
            "active_voxels_per_level": active,
            "detections_per_scan": [int(c) for c in dets.count],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}


def profile_forward(torch, det, batch, path):
    """Device time by kernel over one forward + post_process; returns the
    wall time, the summed device time of all kernels and their ratio."""
    from torch.profiler import ProfilerActivity, profile

    det.post_process(det(batch))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        det.post_process(det(batch))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA" or "cuda" in str(
                  e.device_type).lower()]
    kernel_ms = sum(e.self_device_time_total for e in events) / 1e3
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(prof.key_averages().table(
        sort_by="self_cuda_time_total", row_limit=60))
    return {"wall_ms": wall * 1e3, "kernel_ms": kernel_ms,
            "busy_share": kernel_ms / (wall * 1e3)}


def reference_phase(torch, cfg_mod, synth, models_mod, weights,
                    backbone=None, rtol=3e-2):
    """Narrow model, cropped scene: card vs CPU, on the main path's
    backbone (kernels in bf16 on the card, plain f32 on the CPU; within
    `rtol`) or the given BACKBONE_3D."""
    cfg = cfg_mod.cfg_from_yaml_file(str(ROOT / CFG_FILE))
    m = cfg.MODEL
    if backbone is not None:
        m.BACKBONE_3D = backbone
    m.BACKBONE_3D.update({
        "MAX_VOXELS": 2048, "LEVEL_CAPACITIES": [2048, 2048, 2048, 1024,
                                                 1024],
        "WINDOWED_BLOCK": 512, "CHANNELS": [16, 16, 16, 16, 16],
        "OUT_CHANNELS": 16, "DENSE_DTYPE": "f32"})
    m.MAP_TO_BEV.NUM_BEV_FEATURES = 32
    m.BACKBONE_2D.update({"LAYER_NUMS": [1, 1], "NUM_FILTERS": [16, 32],
                          "NUM_UPSAMPLE_FILTERS": [16, 16]})
    m.DENSE_HEAD.update({"HIDDEN_CHANNEL": 32, "NUM_HEADS": 2,
                         "FFN_CHANNEL": 64, "NUM_PROPOSALS": 20})
    ds = synth.SyntheticDataset(cfg_mod.EDict(synth.bench_data_cfg(
        2, cfg, pcr=[-6.4, -6.4, -5.0, 6.4, 6.4, 3.0], voxel=[0.2, 0.2, 0.2],
        max_voxels=2048, max_points=40000)), cfg.CLASS_NAMES,
        training=False)
    batch = ds.batch(range(2))
    outs = {}
    for dev in ("cuda", "cpu"):
        det = models_mod.build_network(copy.deepcopy(cfg.MODEL), 10, ds,
                                       device=dev)
        weights.init_random_(det, seed=1)
        outs[dev] = det({k: torch.from_numpy(v).to(dev)
                         for k, v in batch.items()})
    g, c = outs["cuda"], outs["cpu"]
    if not torch.equal(g["sparse_active_counts"].cpu(),
                       c["sparse_active_counts"]):
        raise AssertionError("reference: active counts differ")
    if int(g["sparse_window_overflow"]) or int(c["sparse_window_overflow"]):
        raise AssertionError("reference: overflow")
    errs = {}
    for key, a, b in (
            ("encoded_spconv_tensor", g["encoded_spconv_tensor"],
             c["encoded_spconv_tensor"]),
            ("dense_heatmap", g["transfusion_preds"]["dense_heatmap"],
             c["transfusion_preds"]["dense_heatmap"])):
        rel = float((a.cpu() - b).norm() / b.norm().clamp_min(1e-12))
        errs[key] = rel
        # bf16 operands through 16 sparse convs: ~1e-2 relative at most
        if not rel < rtol:
            raise AssertionError(f"reference: {key} rel err {rel}")
    return errs


# ------------------------------------------------------------- training path


def per_sample(fn, args, kw, batched, reduce):
    """Run a plain version one sample at a time (its gather buffers are
    (K, Vt, Cin) floats per sample) and join the results."""
    b = args[batched[0]].shape[0]
    outs = []
    for i in range(b):
        a = [x[i:i + 1] if j in batched else x for j, x in enumerate(args)]
        outs.append(fn(*a, **kw))
    return reduce(outs)


def windowed_hits(torch, ws, src, tgt, lo, deltas, block, window):
    return sum(int(ws.neighbour_rows(src[i:i + 1], tgt[i:i + 1],
                                     lo[i:i + 1], deltas, block,
                                     window)[1].sum())
               for i in range(src.shape[0]))


def check_windowed_conv(torch, ws, k3_calls, direction, label="",
                        before=None):
    """K3 vs plain (sample by sample, with the call's own epilogue
    arguments) on every recorded call; per-call rows. `before`: an earlier
    checkout's K3 wrapper, timed on the same calls."""
    rows = []
    cat = lambda outs: torch.cat(outs, dim=0)          # noqa: E731
    for i, (args, kw) in enumerate(k3_calls):
        src, feats, tgt, lo, deltas, w_flat, block, window = args
        out = ws.conv_kernel(*args, **kw)
        plain = lambda: per_sample(                     # noqa: E731
            ws.windowed_conv_plain, args, plain_kw(kw), (0, 1, 2, 3), cat)
        err, tol = k3_err(torch, out, plain(), f"{label}K3 call {i}")
        hits = windowed_hits(torch, ws, src, tgt, lo, deltas, block, window)
        cin, cout = feats.shape[2], w_flat.shape[1]
        epilogue = kw.get("scale") is not None
        nbytes = (4 * (src.numel() + tgt.numel() + lo.numel()
                       + deltas.numel() + feats.numel())
                  + 2 * w_flat.numel() + 4 * tgt.numel() * cout
                  + (8 * cout if epilogue else 0))
        bound_ms, bound_by = bound_entry(nbytes / HBM_BYTES_PER_S,
                                         2 * cin * cout * hits / BF16_FLOPS)
        rows.append({
            "name": "windowed_conv", "call": i, "direction": direction(i),
            "batch": tgt.shape[0], "vt": tgt.shape[1], "vs": src.shape[1],
            "cin": cin, "cout": cout, "window": window,
            "epilogue": epilogue, "relu": bool(kw.get("relu")), "hits": hits,
            "max_abs_err": err, "tolerance": tol,
            "ms": timing.ms(lambda: ws.conv_kernel(*args, **kw), 5),
            "device_ms": timing.device_ms(
                lambda: ws.conv_kernel(*args, **kw), 5),
            "plain_ms": timing.ms(plain, 1),
            "bound_ms": bound_ms, "bound_by": bound_by})
        if before is not None:
            rows[-1]["before_device_ms"] = timing.device_ms(
                lambda: before.conv_kernel(*args, **kw), 2)
        del out
    return rows


def k3_window_rows(torch, ws, k3_calls):
    """K3's device time with the window slice staged in shared memory (its
    plan) and searched in device memory, at the recorded strided call with
    the widest window whose plan stages it."""
    for args, kw in sorted(k3_calls, key=lambda c: -c[0][7]):
        plan = ws.conv_plan(-(-args[1].shape[2] // 16) * 16,
                            args[5].shape[1], args[7])
        if plan[2] and args[0].shape[1] != args[2].shape[1]:
            break
    rows = []
    for p in (plan, plan[:2] + (False,)):
        ms = with_plan(ws, p, lambda: timing.device_ms(
            lambda: ws.conv_kernel(*args, **kw), 5))
        rows.append({"cin": args[1].shape[2], "cout": args[5].shape[1],
                     "window": args[7], "plan": list(p), "device_ms": ms})
        log(f"K3 window {'staged' if p[2] else 'in device memory'}: "
            f"{args[1].shape[2]}->{args[5].shape[1]} window {args[7]}: "
            f"device {ms:.4f} ms")
    return rows


def check_train_kernels(torch, tp, ws, k2_calls, k3_calls, k4_calls,
                        before=None, k3_forward=3):
    """Every K2 / K3 / K4 launch of one training step against its plain
    version at the recorded arguments; returns per-call rows. The first
    13 K2 and `k3_forward` K3 calls are the step's forward convs, the
    others its backward."""
    rows = []
    cat = lambda outs: torch.cat(outs, dim=0)          # noqa: E731
    for i, (args, kw) in enumerate(k2_calls):
        out = tp.gather_conv(*args, **kw)
        plain = lambda: per_sample(                     # noqa: E731
            tp.posgather_conv_plain, args, kw, (0, 1, 2, 3, 4, 5), cat)
        ref = plain()
        err = float((out - ref).abs().max())
        tol = K2_RTOL * max(float(ref.abs().max()), 1e-3)
        if not (err <= tol and bool(torch.isfinite(out).all())):
            raise AssertionError(f"train K2 call {i}: err {err} > {tol}")
        t_b, t_o, hits = conv_bound(tp, args, kw)
        bound_ms, bound_by = bound_entry(t_b, t_o)
        rows.append({
            "name": "posgather_conv", "call": i,
            "direction": "forward" if i < 13 else "backward",
            "vt": args[2].shape[1], "vs": args[0].shape[1],
            "cin": args[1].shape[2], "cout": args[7].shape[1],
            "hits": hits, "max_abs_err": err, "tolerance": tol,
            "ms": timing.ms(lambda: tp.gather_conv(*args, **kw), 5),
            "plain_ms": timing.ms(plain, 1),
            "bound_ms": bound_ms, "bound_by": bound_by})
        del out, ref
    rows += check_windowed_conv(
        torch, ws, k3_calls,
        lambda i: "forward" if i < k3_forward else "transposed", "train ",
        before)
    for i, (args, kw) in enumerate(k4_calls):
        src, feats, tgt, g, lo, deltas, block, window = args
        out = ws.dw_kernel(*args, **kw)
        plain = lambda: per_sample(                     # noqa: E731
            ws.windowed_dw_plain, args,
            {"compute_dtype": kw["compute_dtype"]}, (0, 1, 2, 3, 4),
            lambda outs: torch.stack(outs).sum(dim=0))
        ref = plain()
        err = float((out - ref).abs().max())
        tol = K4_RTOL * max(float(ref.abs().max()), 1e-3)
        if not (err <= tol and bool(torch.isfinite(out).all())):
            raise AssertionError(f"K4 call {i}: err {err} > {tol}")
        if not torch.equal(out, ws.dw_kernel(*args, **kw)):
            raise AssertionError(f"K4 call {i}: two runs differ")
        hits = windowed_hits(torch, ws, src, tgt, lo, deltas, block, window)
        cin, cout = feats.shape[2], g.shape[2]
        nbytes = 4 * (src.numel() + tgt.numel() + lo.numel()
                      + deltas.numel() + feats.numel() + g.numel()
                      + deltas.numel() * cin * cout)
        bound_ms, bound_by = bound_entry(nbytes / HBM_BYTES_PER_S,
                                         2 * cin * cout * hits / BF16_FLOPS)
        rows.append({
            "name": "windowed_dw", "call": i, "vt": tgt.shape[1],
            "vs": src.shape[1], "cin": cin, "cout": cout, "window": window,
            "hits": hits, "max_abs_err": err, "tolerance": tol,
            "ms": timing.ms(lambda: ws.dw_kernel(*args, **kw), 5),
            "plain_ms": timing.ms(plain, 1),
            "bound_ms": bound_ms, "bound_by": bound_by})
        del out, ref
    return rows


def load_before(path):
    """The K1, K2, K3 and P1-P3 wrappers of an earlier checkout of this
    repo at `path` (`compute_positions`, `positions`, `gather_conv`,
    `conv_kernel`, `take_along`, and its gather-probe module `gp`, whose
    `onehot_gather` and `banded_gather_conv` are P2 and P3): its package
    loaded under another name, its kernels built into its own build/,
    taking this checkout's recorded arguments."""
    import importlib
    import importlib.util

    pkg = Path(path).resolve() / "findnpropagate_torch"
    spec = importlib.util.spec_from_file_location(
        "before_port", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    sys.modules["before_port"] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sys.modules["before_port"])
    bws = importlib.import_module("before_port.ops.windowed_sparse")
    btp = importlib.import_module("before_port.ops.posgather")
    bgp = importlib.import_module("before_port.ops.gather_probes")
    importlib.import_module("before_port.ops._build").build_all(
        ["posgather", "windowed_sparse", "gather_probes"])

    def conv_kernel(*args, centres=None, **kw):
        # the host-side centres, where that checkout's K3 takes them (else
        # it reads the deltas back from the device, which cannot be
        # captured in a CUDA graph); checkouts before tap groups of any
        # size take the three-tap middles alone
        if "centres" in inspect.signature(bws.conv_kernel).parameters:
            kw["centres"] = centres
            if centres is not None and not hasattr(bws, "conv_slices"):
                kw["centres"] = centres[0]
        return bws.conv_kernel(*args, **kw)
    return types.SimpleNamespace(
        conv_kernel=conv_kernel, gather_conv=btp.gather_conv,
        compute_positions=btp.compute_positions, positions=btp.positions,
        take_along=bgp.take_along, gp=bgp)


def k1_before_after(torch, before, run):
    """`run()`'s milliseconds with the earlier checkout's compute_positions
    in the backbone in place of this one's, in turns: before, after, after,
    before."""
    import importlib

    bb = importlib.import_module(
        "findnpropagate_torch.models.backbones_3d.spconv_backbone")

    def with_fn(fn):
        def measure():
            with Swap(bb, "compute_positions", fn):
                return run()
        return measure
    return timing.in_turns(with_fn(before.compute_positions),
                           with_fn(bb.compute_positions))


class Swap:
    """module.name replaced by `fn` inside the block."""

    def __init__(self, module, name, fn):
        self.module, self.name, self.fn = module, name, fn
        self.orig = getattr(module, name)

    def __enter__(self):
        setattr(self.module, self.name, self.fn)

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def step_ms(torch, step, batch):
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    step(batch)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1)


class HostTimer:
    """Adds up the host seconds spent inside module.name."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.seconds = 0.0

    def __enter__(self):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return self.orig(*a, **kw)
            finally:
                self.seconds += time.perf_counter() - t0
        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def launches_now(tp, ws):
    return {**tp.LAUNCHES, **ws.LAUNCHES}


def run_train_step(torch, step, batch, tp, ws, lap, accum, want=None):
    """One optimizer step with the launch counts set to 0 just before and
    read just after; checks what a healthy step must show (`want`: the
    launch counts of one pass, the posgather mode's by default)."""
    tp.reset_launches()
    ws.reset_launches()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    with HostTimer(lap, "_solve_one") as match:
        t0.record()
        metrics = step(batch)
        t1.record()
        torch.cuda.synchronize()
    launches = launches_now(tp, ws)
    want = {k: v * accum for k, v in (want or TRAIN_LAUNCHES).items()}
    if launches != want:
        raise AssertionError(f"train step: launches {launches}, want {want}")
    m = {k: float(v) for k, v in metrics.items()}
    if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
            and m["grad_norm"] > 0):
        raise AssertionError(f"train step: loss {m['loss']} grad_norm "
                             f"{m['grad_norm']}")
    if m["sparse_window_overflow"] != 0:
        raise AssertionError("train step: sparse_window_overflow "
                             f"{m['sparse_window_overflow']}")
    matched = sum(v for k, v in m.items() if k.endswith("_matches"))
    if not matched > 0:
        raise AssertionError("train step: no ground truth was matched")
    return {"ms": t0.elapsed_time(t1), "loss": m["loss"],
            "grad_norm": m["grad_norm"], "matched": matched,
            "matching_host_ms": match.seconds * 1e3, "launches": launches}


def profile_train(torch, step, batch, path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA" or "cuda" in str(
                  e.device_type).lower()]
    kernel_ms = sum(e.self_device_time_total for e in events) / 1e3
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(prof.key_averages().table(
        sort_by="self_cuda_time_total", row_limit=60))
    return {"wall_ms": wall * 1e3, "kernel_ms": kernel_ms,
            "busy_share": kernel_ms / (wall * 1e3)}


def training_phase(torch, mods, cfg, args, report):
    """Phases 5 and 6; returns the per-call rows of the training kernels."""
    cfg_mod, models_mod, synth, tp, ws, lap, weights, optimization, \
        trainer = mods
    b = args.train_batch
    ds = synth.SyntheticDataset(
        cfg_mod.EDict(synth.bench_data_cfg(max(b, 2), cfg)),
        cfg.CLASS_NAMES, training=True)
    det = models_mod.build_network(copy.deepcopy(cfg.MODEL), 10, ds)
    weights.init_random_(det, seed=0)
    det.train()
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in ds.batch(range(b)).items()}
    n_gt = [int(c) for c in (batch["gt_boxes"][..., -1] > 0).sum(dim=1)]
    tx, _ = optimization.build_optimizer(det.parameters(), TRAIN_OPT, 1000)
    step1 = trainer.make_train_step(det, tx, accum_steps=1)
    before = [p.detach().clone() for p in det.parameters()]

    warm = run_train_step(torch, step1, batch, tp, ws, lap, 1)
    log(f"train warm-up step: {warm['ms']:.1f} ms, loss {warm['loss']:.4f}, "
        f"grad norm {warm['grad_norm']:.4f}, matched {warm['matched']:.0f} "
        f"of {sum(n_gt)} boxes, launches {warm['launches']}")
    changed = sum(bool((p.detach() != q).any())
                  for p, q in zip(det.parameters(), before))
    if changed < 0.9 * len(before):
        raise AssertionError(f"train step: only {changed} of {len(before)} "
                             "parameter tensors changed")
    del before

    # the peak of the timed steps alone: model, Adam state, batch and one
    # step's activations; nothing of the kernel checks is alive yet
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    steps = [run_train_step(torch, step1, batch, tp, ws, lap, 1)
             for _ in range(args.train_steps)]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    med = sorted(s["ms"] for s in steps)[len(steps) // 2]
    step2 = trainer.make_train_step(det, tx, accum_steps=2)
    run_train_step(torch, step2, batch, tp, ws, lap, 2)      # warm shapes
    acc = run_train_step(torch, step2, batch, tp, ws, lap, 2)
    report["train"] = {
        "batch": b, "gt_boxes_per_scene": n_gt, "warm_up": warm,
        "steps": steps, "ms_per_step": med, "scans_per_s": 1e3 * b / med,
        "matching_host_ms": sorted(s["matching_host_ms"]
                                   for s in steps)[len(steps) // 2],
        "peak_mem_gb": peak, "accum2": acc, "updates": tx.count}
    log(f"train batch {b}: {med:.1f} ms/step, {1e3 * b / med:.2f} scans/s, "
        f"steps {[round(s['ms'], 1) for s in steps]}, loss "
        f"{[round(s['loss'], 4) for s in steps]}, matching on the host "
        f"{report['train']['matching_host_ms']:.1f} ms/step, peak "
        f"{peak:.2f} GiB; accum_steps=2: {acc['ms']:.1f} ms/step, launches "
        f"{acc['launches']}")
    if args.profile:
        report["train_profile"] = profile_train(
            torch, step1, batch, str(args.profile) + ".train.txt")
        log(f"profile train step: {report['train_profile']}")
    if args.before is not None:
        # the same steps with the earlier checkout's K3 in place of this
        # one's, in turns: before, after, after, before
        ab = {"before": [], "after": []}
        for which in ("before", "after", "after", "before"):
            fn = (args.before.conv_kernel if which == "before"
                  else ws.conv_kernel)
            with Swap(ws, "conv_kernel", fn):
                ab[which].append(step_ms(torch, step1, batch))
        report["train"]["k3_before_after_ms"] = ab
        log(f"train step with the earlier K3 / this K3: {ab}")
        ab = k1_before_after(torch, args.before,
                             lambda: step_ms(torch, step1, batch))
        report["train"]["k1_before_after_ms"] = ab
        log(f"train step with the earlier / this compute_positions: {ab}")

    # one last step, untimed and after the profiled one, whose kernel
    # arguments are kept for phase 6
    with record_positions(torch, tp) as k1_calls, \
            Recorder(tp, "gather_conv", torch) as k2_rec, \
            Recorder(ws, "conv_kernel", torch) as k3_rec, \
            Recorder(ws, "dw_kernel", torch) as k4_rec:
        run_train_step(torch, step1, batch, tp, ws, lap, 1)

    del det, tx, step1, step2
    torch.cuda.empty_cache()
    pallas_train_phase(torch, mods, cfg, report)
    torch.cuda.empty_cache()
    rows = check_positions(torch, tp, k1_calls, "train ", args.before)
    log_positions_rows(rows, "train ")
    conv_rows = check_train_kernels(torch, tp, ws, k2_rec.calls,
                                    k3_rec.calls, k4_rec.calls,
                                    args.before)
    log_conv_rows(conv_rows)
    report["k3_window"] = k3_window_rows(torch, ws, k3_rec.calls)
    return rows + conv_rows


def pallas_train_phase(torch, mods, cfg, report):
    """One training step at batch 1 in SUBM_IMPL: pallas mode (13
    submanifold and 3 strided convs forward through K3, 12 + 3 transposed,
    16 weight gradients through K4) beside a posgather-mode step on the same
    scene and weights: its own launch counts, overflow 0, and the same loss
    within PALLAS_TRAIN_RTOL."""
    cfg_mod, models_mod, synth, tp, ws, lap, weights, optimization, \
        trainer = mods
    ds = synth.SyntheticDataset(cfg_mod.EDict(synth.bench_data_cfg(2, cfg)),
                                cfg.CLASS_NAMES, training=True)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in ds.batch(range(1)).items()}
    res = {}
    for impl in ("posgather", "pallas"):
        mcfg = copy.deepcopy(cfg.MODEL)
        mcfg.BACKBONE_3D["SUBM_IMPL"] = impl
        det = models_mod.build_network(mcfg, 10, ds)
        weights.init_random_(det, seed=0)
        det.train()
        tx, _ = optimization.build_optimizer(det.parameters(), TRAIN_OPT,
                                             1000)
        step = trainer.make_train_step(det, tx, accum_steps=1)
        res[impl] = run_train_step(
            torch, step, batch, tp, ws, lap, 1,
            want=PALLAS_TRAIN_LAUNCHES if impl == "pallas" else None)
        del det, tx, step
    a, b = res["pallas"]["loss"], res["posgather"]["loss"]
    rel = abs(a - b) / max(abs(b), 1e-12)
    report["pallas_train"] = {"batch": 1, "pallas": res["pallas"],
                              "posgather": res["posgather"],
                              "loss_rel_diff": rel}
    log(f"train step, SUBM_IMPL pallas, batch 1: loss {a:.4f} (posgather "
        f"{b:.4f}, rel diff {rel:.3g}), {res['pallas']['ms']:.1f} ms "
        f"(posgather {res['posgather']['ms']:.1f} ms, both first steps), "
        f"launches {res['pallas']['launches']}")
    if not rel <= PALLAS_TRAIN_RTOL:
        raise AssertionError(f"pallas-mode training loss {a} vs posgather "
                             f"{b}: rel diff {rel}")


# ------------------------------------------------------------- the probes


PROBE_MAINS = [
    # findnpropagate_torch/tools/<module>, argv: each at its own shapes
    ("probe_gather", []), ("probe_gather2", []), ("probe_gather3", []),
    ("probe_posgather", []), ("probe_posgather2", ["--mode", "cpu"]),
    ("probe_posgather2", ["--mode", "gpu"]), ("probe_posgather3", []),
]
PROBE_KERNELS = ("take_along", "onehot_gather", "banded_gather_conv")


def take_bound(torch, gp, x, idx, axis, taps=False):
    """P1 moves bytes only: the input and the index as given read once,
    the output written once."""
    out = math.prod(gp.index_strides(x, idx, axis, taps)[0]) \
        * x.element_size()
    return (x.numel() * x.element_size() + 4 * idx.numel() + out) \
        / HBM_BYTES_PER_S, 0.0


def onehot_bound(torch, gp, x, ids, want, tap_win=None, wt=None, blocks=1):
    """P2: the inputs once (the first tap_win ids), the output once; a
    search of log2(tap_win) steps per target and block (as the probe's
    blocks repeat it), and with weights 2*Cout*C flops per found id and
    block on the tensor cores."""
    c, s = x.shape
    taps, w = want.shape
    n = s if tap_win is None else tap_win
    rows = taps * c if wt is None else wt.shape[0]
    nbytes = (2 * x.numel() + 4 * n + 4 * want.numel() + 2 * rows * blocks * w
              + (0 if wt is None else 2 * wt.numel()))
    t_ops = blocks * taps * w * math.ceil(math.log2(n + 1)) / CUDA_CORE_OPS
    if wt is not None:
        hits = int(torch.isin(want, ids[:n]).sum())
        t_ops += 2 * wt.shape[0] * c * hits * blocks / BF16_FLOPS
    return nbytes / HBM_BYTES_PER_S, t_ops


def banded_bound(torch, gp, starts, feats, rel, wt, band):
    """P3: the inputs and the bf16 output once; 2*Cout*C flops per gathered
    (target, tap) on the tensor cores."""
    c, s = feats.shape
    nb = starts.shape[0]
    valid = int((gp.band_positions(starts, rel, band, s) >= 0).sum())
    nbytes = (4 * starts.numel() + 2 * feats.numel() + 4 * rel.numel()
              + 2 * wt.numel() + 2 * wt.shape[0] * nb * rel.shape[1])
    return nbytes / HBM_BYTES_PER_S, 2 * wt.shape[0] * c * valid / BF16_FLOPS


def take_library(torch, x, idx, axis, taps=False):
    """One PyTorch call that computes P1 where every index is in range
    (torch.take_along_dim, or indexing for the side-by-side taps), on int64
    indices made beforehand; None elsewhere (it asserts out of range)."""
    if not bool(((idx >= 0) & (idx < x.shape[axis])).all()):
        return None
    i = idx.long()
    if not taps:
        return lambda: torch.take_along_dim(x, i, dim=axis)
    if axis == 1:
        return lambda: torch.take_along_dim(x[None], i[:, None], dim=2)
    it = i.t()
    return lambda: x[it]


def signature(torch, args, kw):
    """A call's shapes, types, strides and other argument values."""
    sig = lambda x: (tuple(x.shape), str(x.dtype), x.stride()) \
        if isinstance(x, torch.Tensor) else repr(x)  # noqa: E731
    return (tuple(sig(a) for a in args),
            tuple((k, sig(v)) for k, v in sorted(kw.items())))


def check_probe_kernels(torch, gp, calls, before=None):
    """Every recorded P1/P2/P3 call of the probes' run through the kernel
    and through its plain version on the card: P1 and P2 without weights
    bit-equal (NaN where the plain version has NaN), P2 with weights and P3
    (bf16 outputs of f32 sums in another order) within 1e-3 of the output's
    scale plus one bf16 step of each element. One row per signature
    (`signature`: calls that differ only in their data), with the number of
    its calls checked, their largest error, and, timed on its first call,
    ms, device ms, plain ms, bound, for P1 the library call's time, the
    wrapper's host time split (`host_split`) and, for P2 and P3, the syncs,
    host-to-device copies and launches per call (`runtime_calls`: 0, 0 and
    1, or the run fails); with `before`, the earlier checkout's kernel on
    the same call: ms, host split, and device ms in turns with this one's
    (`timing.in_turns`; `before_device_ms` the better of its two)."""
    from findnpropagate_torch.tools._common import bf16_close, same

    bounds = {"take_along": take_bound, "onehot_gather": onehot_bound,
              "banded_gather_conv": banded_bound}
    rows = []
    for name in PROBE_KERNELS:
        kernel, plain = getattr(gp, name), getattr(gp, name + "_plain")
        by_sig = {}
        for i, (args, kw) in enumerate(calls[name]):
            out = kernel(*args, **kw)
            ref = plain(*args, **kw)
            torch.cuda.synchronize()
            exact = name == "take_along" or (
                name == "onehot_gather" and kw.get("wt") is None)
            ok, err = (same(out, ref), 0.0) if exact else bf16_close(out,
                                                                     ref)
            if not ok:
                raise AssertionError(f"{name} call {i}: kernel != plain"
                                     + ("" if exact else f" (err {err})"))
            key = signature(torch, args, kw)
            if key in by_sig:
                row = by_sig[key]
                row["calls"] += 1
                row["max_abs_err"] = max(row["max_abs_err"], err)
                row["nan_outputs"] += int(out.isnan().sum())
                continue
            library = take_library(torch, *args, **kw) \
                if name == "take_along" else None
            bound_ms, bound_by = bound_entry(*bounds[name](torch, gp, *args,
                                                           **kw))
            by_sig[key] = {
                "name": name, "call": len(by_sig), "calls": 1,
                "shapes": [list(a.shape) for a in args
                           if isinstance(a, torch.Tensor)],
                "dtype": str(args[0].dtype).replace("torch.", ""),
                "options": {k: (list(v.shape) if isinstance(v, torch.Tensor)
                                else v) for k, v in kw.items()},
                "scalars": [a for a in args
                            if not isinstance(a, torch.Tensor)],
                "nan_outputs": int(out.isnan().sum()),
                "max_abs_err": err, "exact": exact,
                "ms": timing.ms(lambda: kernel(*args, **kw), 20),
                "device_ms": timing.device_ms(
                    lambda: kernel(*args, **kw), 20),
                "plain_ms": timing.ms(lambda: plain(*args, **kw), 3),
                "library_ms": None if library is None
                else timing.ms(library, 20),
                "library_device_ms": None if library is None
                else timing.device_ms(library, 20),
                "bound_ms": bound_ms, "bound_by": bound_by}
            call = lambda: kernel(*args, **kw)  # noqa: E731
            row = by_sig[key]
            row["host_us"] = host_split(torch, call)
            if name != "take_along":
                row["syncs"], row["h2d_copies"], row["launches_seen"] = \
                    runtime_calls(torch, call)
                if row["syncs"] or row["h2d_copies"] \
                        or row["launches_seen"] != 1:
                    raise AssertionError(
                        f"{name}: {row['syncs']} syncs, {row['h2d_copies']} "
                        f"host-to-device copies and {row['launches_seen']} "
                        "launches per call (want 0, 0, 1)")
            if before is not None:
                bcall = lambda: getattr(before.gp, name)(  # noqa: E731
                    *args, **kw)
                row["before_host_us"] = host_split(torch, bcall)
                row["before_ms"] = timing.ms(bcall, 20)
                row["turns_device_ms"] = timing.in_turns(
                    lambda: timing.device_ms(bcall, 20),
                    lambda: timing.device_ms(call, 20))
                row["before_device_ms"] = min(
                    row["turns_device_ms"]["before"])
                if name != "take_along":
                    row["before_syncs"], row["before_h2d_copies"], \
                        row["before_launches_seen"] = runtime_calls(
                            torch, bcall)
            rows.append(by_sig[key])
            del out, ref
    return rows


def probe_corners(torch, gp):
    """P2 and P3 against their plain versions (P2 without weights bit-equal,
    the others `bf16_close`) where the probes' own calls do not reach
    (numpy seed 0): P3 with rel below 0 and at or above band*128 and
    starts that put columns outside [0, S); P2 with wanted ids beyond
    tap_win and ids not there; S not a multiple of 8; one 128-target tile
    and one block; 9 taps; a window at the size limit
    (gather_probes.max_window), and one row more refused with ValueError
    before any launch. Last, unsorted ids make the P2 kernel trap
    (`unsorted_ids_refused`)."""
    from findnpropagate_torch.tools._common import bf16_close, same

    rng = np.random.RandomState(0)
    rows = []

    def bf16(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(
            "cuda", torch.bfloat16)

    def i32(a):
        return torch.from_numpy(np.asarray(a, np.int32)).cuda()

    def hold(label, name, args, kw, stats):
        out = getattr(gp, name)(*args, **kw)
        ref = getattr(gp, name + "_plain")(*args, **kw)
        torch.cuda.synchronize()
        exact = name == "onehot_gather" and kw.get("wt") is None
        ok, err = (same(out, ref), 0.0) if exact else bf16_close(out, ref)
        if not ok:
            raise AssertionError(f"probe corner {label}: {name} != plain"
                                 + ("" if exact else f" (err {err})"))
        rows.append({"case": label, "kernel": name, "exact": exact,
                     "max_abs_err": err, **stats})
        log(f"probe corner {label:52s} {name}: err {err:.3g} {stats}")

    def refused(label, fn):
        try:
            fn()
        except ValueError as e:
            rows.append({"case": label, "refused": str(e)})
            log(f"probe corner {label:52s} refused: {e}")
            return
        raise AssertionError(f"probe corner {label}: not refused")

    def p3(label, s, w, nb, taps, band, rel_range, start_range):
        feats = bf16(rng.randn(16, s))
        rel = i32(rng.randint(*rel_range, (taps, w)))
        starts = i32(rng.randint(*start_range, (nb, taps, w // 128)))
        wt = bf16(rng.randn(16, taps * 16) * 0.1)
        col = starts.long().repeat_interleave(128, dim=2) + rel.long()[None]
        in_band = ((rel >= 0) & (rel < band * 128))[None]
        stats = {"s": s, "w": w, "nb": nb, "taps": taps, "band": band,
                 "rel_outside_band": int((~in_band).sum()) * nb,
                 "column_outside": int((in_band & ((col < 0) | (col >= s)))
                                       .sum()),
                 "gathered": int((gp.band_positions(starts, rel, band, s)
                                  >= 0).sum())}
        hold(label, "banded_gather_conv", (starts, feats, rel, wt, band), {},
             stats)
        return stats

    def p2(label, s, w, taps, tap_win=None, blocks=1, ids=None):
        n = s if tap_win is None else tap_win
        x = bf16(rng.randn(16, s))
        if ids is None:
            ids = np.sort(rng.choice(10 * s, s, replace=False))
        pick = rng.randint(0, 3, (taps, w))
        inside = ids[rng.randint(0, n, (taps, w))]
        beyond = ids[rng.randint(n, s, (taps, w))] if n < s else inside
        absent = rng.randint(max(int(ids[0]) - 50, -2 ** 31),
                             int(ids[-1]) // 2 + 50, (taps, w),
                             dtype=np.int64)
        want = np.where(pick == 0, inside, np.where(pick == 1, beyond,
                                                    absent))
        kw = {} if tap_win is None else dict(
            tap_win=tap_win, wt=bf16(rng.randn(16, taps * 16) * 0.1),
            blocks=blocks)
        stats = {"s": s, "w": w, "taps": taps, "tap_win": n,
                 "blocks": blocks,
                 "found": int(np.isin(want, ids[:n]).sum()),
                 "beyond_tap_win": int(np.isin(want, ids[n:]).sum()),
                 "not_there": int((~np.isin(want, ids)).sum())}
        hold(label, "onehot_gather", (x, i32(ids), i32(want)), kw, stats)
        return stats

    st = p3("P3 rel outside the band, columns outside [0, S)", 2048, 1024,
            3, 27, 3, (-200, 3 * 128 + 200), (-400, 2048 + 100))
    if not (st["rel_outside_band"] and st["column_outside"]):
        raise AssertionError(f"probe corner P3: no case outside: {st}")
    p3("P3 S not a multiple of 8", 2045, 256, 2, 27, 2, (0, 256),
       (0, 2045 - 128))
    p3("P3 one tile, nb 1", 2048, 128, 1, 27, 4, (0, 512), (0, 1536))
    p3("P3 9 taps", 1000, 256, 2, 9, 2, (0, 256), (0, 744))
    lim = gp.max_window(27, False)
    p3(f"P3 window at the limit, S {lim}", lim, 1024, 4, 27, 4, (0, 512),
       (0, lim - 512))
    feats = torch.zeros(16, lim + 1, dtype=torch.bfloat16, device="cuda")
    refused(f"P3 S {lim + 1}", lambda: gp.banded_gather_conv(
        torch.zeros(1, 27, 1, dtype=torch.int32, device="cuda"), feats,
        torch.zeros(27, 128, dtype=torch.int32, device="cuda"),
        torch.zeros(16, 432, dtype=torch.bfloat16, device="cuda"), 2))

    st = p2("P2 want beyond tap_win and not there", 2048, 1024, 27, 1000, 3)
    if not (st["found"] and st["beyond_tap_win"] and st["not_there"]):
        raise AssertionError(f"probe corner P2: a kind of id missing: {st}")
    p2("P2 S not a multiple of 8", 2045, 256, 27, 2045, 2)
    p2("P2 one tile, nb 1", 2048, 128, 27, 1536, 1)
    p2("P2 9 taps", 1000, 256, 9, 700, 2)
    # the search index's buckets: negative ids, a gap of 2^30 between two
    # clusters, and the int32 ends
    clustered = np.concatenate([np.arange(-700, 300), 2 ** 30 + np.arange(
        1000), [-2 ** 31, 2 ** 31 - 1]])
    clustered = np.sort(clustered)
    p2("P2 ids in two clusters and at the int32 ends", 2002, 256, 27, 1900,
       2, ids=clustered)
    p2("P2 without weights, ids in two clusters and at the int32 ends",
       2002, 256, 27, ids=clustered)
    lim = gp.max_window(27, True)
    p2(f"P2 window at the limit, tap_win {lim}", 6000, 512, 27, lim, 2)
    x = torch.zeros(16, 6000, dtype=torch.bfloat16, device="cuda")
    ids6k = torch.arange(6000, dtype=torch.int32, device="cuda")
    want = torch.zeros(27, 128, dtype=torch.int32, device="cuda")
    refused(f"P2 tap_win {lim + 1}", lambda: gp.onehot_gather(
        x, ids6k, want, tap_win=lim + 1,
        wt=torch.zeros(16, 432, dtype=torch.bfloat16, device="cuda")))

    p2("P2 without weights, ids there and not", 2048, 1024, 27)
    p2("P2 without weights, S not a multiple of 8", 2045, 256, 27)
    p2("P2 without weights, one tile", 2048, 128, 27)
    lim = gp.max_ids()
    p2(f"P2 without weights, window at the limit, S {lim}", lim, 256, 27)
    refused(f"P2 without weights, S {lim + 1}", lambda: gp.onehot_gather(
        torch.zeros(16, lim + 1, dtype=torch.bfloat16, device="cuda"),
        torch.arange(lim + 1, dtype=torch.int32, device="cuda"), want))

    for mode, said in unsorted_ids_refused().items():
        rows.append({"case": f"P2 {mode} with a duplicate id",
                     "refused": said})
        log(f"probe corner P2 {mode} with a duplicate id: {said}")
    return rows


UNSORTED_IDS = """
import sys
import torch
sys.path.insert(0, sys.argv[1])
from findnpropagate_torch.ops import gather_probes as gp
x = torch.zeros(16, 256, dtype=torch.bfloat16, device="cuda")
ids = torch.arange(256, dtype=torch.int32, device="cuda") * 2
ids[200] = ids[199]
want = torch.zeros(27, 128, dtype=torch.int32, device="cuda")
kw = {} if sys.argv[2] == "gather" else dict(
    tap_win=250, blocks=2,
    wt=torch.zeros(16, 432, dtype=torch.bfloat16, device="cuda"))
try:
    gp.onehot_gather(x, ids, want, **kw)
    torch.cuda.synchronize()
except RuntimeError as e:
    print(str(e).strip().splitlines()[0])
    sys.exit(0)
sys.exit(1)
"""


def unsorted_ids_refused():
    """P2 without and with weights on ids with a duplicate among those it
    compares, each in a process of its own (a trap ends the process's
    CUDA context): the launch must fail at the next synchronisation.
    Returns what each process's error said."""
    procs = {mode: subprocess.Popen(
        [sys.executable, "-c", UNSORTED_IDS, str(ROOT), mode],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for mode in ("gather", "product")}
    said = {}
    try:
        for mode, proc in procs.items():
            out, err = proc.communicate(timeout=300)
            if proc.returncode != 0:
                raise AssertionError(f"P2 {mode} with unsorted ids was not "
                                     f"refused: {out}{err[-2000:]}")
            said[mode] = out.strip()
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return said


class Tee(io.TextIOBase):
    """A text stream that writes through to `out` and keeps a copy."""

    def __init__(self, out):
        self.out, self.copy = out, io.StringIO()

    def write(self, text):
        self.copy.write(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def probes_phase(torch, gp, before=None):
    """The six ported probes (findnpropagate_torch/tools/) at their own
    shapes, the P1-P3 launch counts set to 0 just before and read just
    after; then every P1-P3 call of that run held against its plain version
    (`check_probe_kernels`), apart from the repeats inside the probes'
    timing loops and CUDA-graph captures, which relaunch a call already
    recorded on the same tensors. Returns (launches, rows, each probe's
    printed lines)."""
    import importlib

    depth = [0]                      # timing loops under way

    def timed(fn):
        def run(*a, **kw):
            depth[0] += 1
            try:
                return fn(*a, **kw)
            finally:
                depth[0] -= 1
        return run

    def skip():
        return depth[0] > 0 or torch.cuda.is_current_stream_capturing()

    gp.reset_launches()
    printed = {}
    with contextlib.ExitStack() as stack:
        for fn in ("ms", "device_ms"):
            stack.enter_context(Swap(timing, fn, timed(getattr(timing, fn))))
        recs = {name: stack.enter_context(
            Recorder(gp, name, torch, skip=skip)) for name in PROBE_KERNELS}
        for mod, argv in PROBE_MAINS:
            log(f"-- python -m findnpropagate_torch.tools.{mod} "
                + " ".join(argv))
            tee = Tee(sys.stdout)
            with contextlib.redirect_stdout(tee):
                rc = importlib.import_module(
                    f"findnpropagate_torch.tools.{mod}").main(argv)
            printed[" ".join([mod, *argv])] = tee.copy.getvalue(
            ).splitlines()
            if rc != 0:
                raise AssertionError(f"{mod} exited with {rc}")
    torch.cuda.synchronize()
    launches = dict(gp.LAUNCHES)
    if not all(launches.values()):
        raise AssertionError(f"probes: a kernel never launched: {launches}")
    rows = check_probe_kernels(torch, gp, {
        name: rec.calls for name, rec in recs.items()}, before)
    log(f"probe kernel calls held against their plain versions: "
        f"{sum(r['calls'] for r in rows)} ({len(rows)} signatures)")
    for r in rows:
        log(f"{r['name']:18s} call {r['call']:2d} x{r['calls']:<2d} "
            f"{r['dtype']:8s} "
            f"{r['shapes']} {r['scalars']} {r['options']} err "
            f"{r['max_abs_err']:.3g}  ms "
            f"{r['ms']:.4f} (device {r['device_ms']:.4f})  plain "
            f"{r['plain_ms']:.3f}  library "
            + ("none" if r["library_ms"] is None else
               f"{r['library_ms']:.4f} (device "
               f"{r['library_device_ms']:.4f})")
            + f"  bound {r['bound_ms']:.4f} ({r['bound_by']})"
            + ("" if "before_ms" not in r else
               f"  before {r['before_ms']:.4f} (device "
               f"{r['before_device_ms']:.4f}; in turns "
               f"{r['turns_device_ms']})")
            + "".join(f"  {k} {r[k]}" for k in (
                "syncs", "h2d_copies", "launches_seen", "before_syncs",
                "before_h2d_copies", "before_launches_seen") if k in r)
            + "".join(f"  {k} " + " ".join(
                f"{f} {v:.1f}" for f, v in r[k].items())
                for k in ("host_us", "before_host_us") if k in r))
    return launches, rows, printed


def log_conv_rows(rows):
    for r in rows:
        dev = (f" (device {r['device_ms']:.4f}"
               + (f", before {r['before_device_ms']:.4f}"
                  if "before_device_ms" in r else "") + ")"
               if "device_ms" in r else "")
        log(f"{r['name']:15s} call {r['call']:2d} "
            f"{r.get('direction', ''):10s} vt={r['vt']} "
            f"{r['cin']}->{r['cout']} hits {r['hits']} err "
            f"{r['max_abs_err']:.3g}  ms {r['ms']:.4f}{dev}  plain "
            f"{r['plain_ms']:.3f}  bound {r['bound_ms']:.4f} "
            f"({r['bound_by']})")


def pallas_phase(torch, models_mod, cfg, ds, det, batch, tp, ws, reps,
                 before=None):
    """Phase 7: SUBM_IMPL pallas (K3 + fused epilogue everywhere), batch 1:
    every K3 launch against its plain version with the same epilogue, the
    forward against the posgather forward on the same weights, and its
    ms/scan (with `before`, also with an earlier checkout's K3 in place of
    this one's). Returns (errors, per-call rows, times)."""
    pcfg = copy.deepcopy(cfg.MODEL)
    pcfg.BACKBONE_3D["SUBM_IMPL"] = "pallas"
    pdet = models_mod.build_network(pcfg, 10, ds)
    pdet.load_state_dict(det.state_dict())
    # every sparse conv's output, in call order, of both modes
    backbone_cls = type(det.backbone_3d)
    orig, convs = backbone_cls._sparse_conv, {}

    def keep(self, *a, **kw):
        y = orig(self, *a, **kw)
        convs.setdefault(self.impl, []).append(y)
        return y

    backbone_cls._sparse_conv = keep
    try:
        ref = det(batch)
        ws.reset_launches()
        tp.reset_launches()
        with Recorder(ws, "conv_kernel", torch) as k3_rec:
            out = pdet(batch)
        torch.cuda.synchronize()
    finally:
        backbone_cls._sparse_conv = orig
    launches = launches_now(tp, ws)
    if launches != {"positions": 0, "posgather_conv": 0,
                    "windowed_conv": 16, "windowed_dw": 0}:
        raise AssertionError(f"pallas mode: launches {launches}")
    if int(out["sparse_window_overflow"]) != 0:
        raise AssertionError("pallas mode: overflow")
    if not all(kw.get("scale") is not None and kw.get("sentinel") is not None
               for _, kw in k3_rec.calls):
        raise AssertionError("pallas mode: a K3 launch had no epilogue")
    rows = check_windowed_conv(torch, ws, k3_rec.calls,
                               lambda i: "eval epilogue", "pallas mode ",
                               before)
    times = {"ms_per_scan": forward_ms(torch, pdet, batch, reps)[0]}
    if before is not None:
        with Swap(ws, "conv_kernel", before.conv_kernel):
            times["before_ms_per_scan"] = forward_ms(torch, pdet, batch,
                                                     reps)[0]
    log(f"pallas-mode forward, batch 1: {times}")
    worst = 0.0
    for i, (a, b) in enumerate(zip(convs["pallas"], convs["posgather"])):
        rel = float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))
        worst = max(worst, rel)
        # same bf16 products, f32 sums in another tap order
        if not rel < 1e-3:
            raise AssertionError(f"pallas mode: conv {i} rel err {rel}")
    errs = {"sparse_convs_worst_max_rel": worst, "sparse_convs": len(
        convs["pallas"])}
    for key, a, b in (
            ("encoded_spconv_tensor", out["encoded_spconv_tensor"],
             ref["encoded_spconv_tensor"]),
            ("dense_heatmap", out["transfusion_preds"]["dense_heatmap"],
             ref["transfusion_preds"]["dense_heatmap"])):
        rel = float((a - b).norm() / b.norm().clamp_min(1e-12))
        errs[key] = rel
        # after the bf16 dense tail the two mostly round to the same values
        if not rel < 1e-2:
            raise AssertionError(f"pallas mode: {key} rel err {rel}")
    return errs, rows, times


SEEKER_CFG = "tools/cfgs/nuscenes_models/nuscenes_box_seeker_proposals.yaml"
KITTI_SEEKER_CFG = "tools/cfgs/kitti_models/kitti_box_seeker_proposals.yaml"
# The card's seeker is held against the port's own CPU run on the same
# inputs: valid and labels equal, and per valid detection the same
# proposal (boxes within SEEKER_BOX_ATOL, oracle within SEEKER_ORACLE_ATOL).
# The one allowed exception is a detection whose top two oracle scores on
# the CPU lie within SEEKER_TIE: CUDA's and the CPU's transcendental
# functions differ by an ulp or two, which can move a point across a box
# face or reorder two near-equal proposals. For the SEG filter, a
# detection whose foreground mask differs is allowed only where one of its
# points' CPU probabilities lies within SEG_MARGIN of a decision threshold
# (the network's matmuls sum in another order on the card).
SEEKER_BOX_ATOL = 1e-4
SEEKER_ORACLE_ATOL = 1e-3
SEEKER_TIE = 1e-3
SEG_MARGIN = 1e-4
SEEKER_REPS = 10
# host syncs per nuScenes frame: one to find the rows of the 2D NMS that
# suppress anything, one to size the compacted on-box buffer
SEEKER_SYNCS = 2
# the KITTI frame: a 64-beam sweep's points, 32 detections, and the
# calibration of tests/test_seeker_kitti_parity.py::make_kitti_calib
KITTI_POINTS = 120000
KITTI_DETS = 32
KITTI_P2 = [[721.5, 0.0, 609.6, 44.85], [0.0, 721.5, 172.8, 0.216],
            [0.0, 0.0, 1.0, 0.0027]]
KITTI_V2C = [[0.0, -1.0, 0.0, -0.002], [0.0, 0.0, -1.0, -0.075],
             [1.0, 0.0, 0.0, -0.272]]


def bench_seeker_inputs(num_dets=96, num_points=200000):
    """bench.py:277-328's seeker inputs, numpy seed 0: the 6-camera yaw
    ring (K = 1266.4 / 800 / 450), points uniform in +-54 m with z in
    [-3, 1], 96 random 2D boxes over the cameras."""
    rng = np.random.RandomState(0)
    k = np.array([[1266.4, 0, 800.0], [0, 1266.4, 450.0], [0, 0, 1.0]])
    r_c2l = np.array([[0, 0, 1.0], [-1, 0, 0], [0, -1, 0]])
    l2i, c2l, intr = [], [], []
    for ci in range(6):
        yaw = ci * np.pi / 3
        rot = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                        [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1.0]])
        c = np.eye(4)
        c[:3, :3] = rot @ r_c2l
        l2c = np.linalg.inv(c)
        m = np.eye(4)
        m[:3, :3] = k @ l2c[:3, :3]
        m[:3, 3] = k @ l2c[:3, 3]
        i4 = np.eye(4)
        i4[:3, :3] = k
        l2i.append(m)
        c2l.append(c)
        intr.append(i4)
    pts = rng.uniform(-54, 54, (num_points, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-3, 1, num_points)
    boxes = np.zeros((num_dets, 4), np.float32)
    boxes[:, 0] = rng.uniform(0, 1400, num_dets)
    boxes[:, 1] = rng.uniform(0, 700, num_dets)
    boxes[:, 2] = boxes[:, 0] + rng.uniform(40, 200, num_dets)
    boxes[:, 3] = boxes[:, 1] + rng.uniform(40, 200, num_dets)
    labels = rng.randint(1, 11, num_dets).astype(np.int32)
    scores = rng.uniform(0.2, 1.0, num_dets).astype(np.float32)
    cams = rng.randint(0, 6, num_dets).astype(np.int32)
    mats = tuple(np.stack(x).astype(np.float32) for x in (l2i, c2l, intr))
    return mats, pts, (boxes, labels, scores, cams)


def bench_seeker_frame(class_names, work):
    """bench_seeker_inputs with its detections written as one COCO file
    per camera under `work` (boxes xyxy) and a PreprocessedDetector over
    them: (matrices, points, detections, detector, image names)."""
    from findnpropagate_torch.openvocab.preprocessed_detector import (
        CAMERA_NAMES,
        PreprocessedDetector,
    )

    mats, pts, (boxes, labels, scores, cams) = bench_seeker_inputs()
    preds, images = [], []
    for c, name in enumerate(CAMERA_NAMES):
        images.append(f"samples/{name}/frame0__{name}.jpg")
        preds.append(work / f"{name}.json")
        sel = cams == c
        write_coco(preds[-1], images[-1], class_names, boxes[sel],
                   labels[sel], scores[sel])
    detector = PreprocessedDetector(preds, class_names, box_fmt="xyxy",
                                    max_dets=len(boxes))
    return mats, pts, (boxes, labels, scores, cams), detector, images


def write_coco(path, image_name, class_names, boxes, labels, scores):
    """One COCO-format prediction file for one image, its boxes as given
    (xyxy, or xywh where the reader takes that)."""
    Path(path).write_text(json.dumps({
        "images": [{"id": 1, "file_name": image_name}],
        "categories": [{"id": i + 1, "name": n}
                       for i, n in enumerate(class_names)],
        "annotations": [{"image_id": 1, "bbox": [float(v) for v in b],
                         "category_id": int(lb), "score": float(s)}
                        for b, lb, s in zip(boxes, labels, scores)]}))


def top2_margins(torch, calls):
    """Per detection, the gap between its two best valid oracle scores, from
    the recorded nms_normal_bev call of a propose (inf with one valid)."""
    (args, kw), = calls
    s = torch.where(kw["valid_mask"], args[1],
                    torch.full_like(args[1], float("-inf")))
    top = s.topk(2, dim=-1).values
    return (top[:, 0] - top[:, 1]).nan_to_num(float("inf")).cpu().numpy()


def hold_seeker(torch, label, card, cpu, margins, exempt=None):
    """The card's SeekerOutput against the CPU's (see SEEKER_TIE); returns
    the comparison's numbers and its exceptions, each with its margin."""
    exempt = exempt or {}
    card = [t.cpu().numpy() for t in card]
    cpu = [t.numpy() for t in cpu]
    boxes_c, _, oracle_c, labels_c, valid_c = card
    boxes_h, _, oracle_h, labels_h, valid_h = cpu
    if not np.array_equal(labels_c, labels_h):
        raise AssertionError(f"{label}: labels differ between card and CPU")
    if not valid_h.any():
        raise AssertionError(f"{label}: no valid proposal on the CPU")
    exceptions, box_err, oracle_err = [], 0.0, 0.0
    for d in np.nonzero(valid_c | valid_h)[0]:
        if valid_c[d] != valid_h[d]:
            if d not in exempt:
                raise AssertionError(f"{label}: det {d} valid "
                                     f"{valid_c[d]} on the card, "
                                     f"{valid_h[d]} on the CPU")
            exceptions.append({"det": int(d), "why": "seg mask",
                               "margin": exempt[d]})
            continue
        if not np.isfinite(boxes_c[d]).all():
            raise AssertionError(f"{label}: det {d} non-finite box")
        be = float(np.abs(boxes_c[d] - boxes_h[d]).max())
        oe = float(abs(oracle_c[d] - oracle_h[d]))
        if be <= SEEKER_BOX_ATOL and oe <= SEEKER_ORACLE_ATOL:
            box_err, oracle_err = max(box_err, be), max(oracle_err, oe)
            continue
        if d in exempt:
            exceptions.append({"det": int(d), "why": "seg mask",
                               "margin": exempt[d], "box_err": be})
        elif margins[d] < SEEKER_TIE:
            exceptions.append({"det": int(d), "why": "oracle tie",
                               "margin": float(margins[d]), "box_err": be})
        else:
            raise AssertionError(
                f"{label}: det {d} box err {be:.3g}, oracle err {oe:.3g}, "
                f"CPU top-two margin {margins[d]:.3g}")
    for e in exceptions:
        log(f"  {label} exception: det {e['det']} ({e['why']}, margin "
            f"{e['margin']:.3g})")
    return {"dets": len(valid_h), "valid": int(valid_h.sum()),
            "max_box_err": box_err, "max_oracle_err": oracle_err,
            "exceptions": exceptions}


def frame_ms(torch, fn, reps, warm=2):
    """(median, all) ms of `reps` calls of fn after `warm`, each timed by
    CUDA events and synchronised."""
    times = []
    for i in range(reps + warm):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        if i >= warm:
            times.append(t0.elapsed_time(t1))
    return sorted(times)[len(times) // 2], times


def profile_frame(torch, fn, path):
    """One call of fn under torch.profiler: wall, summed kernel time, busy
    share and the five kernels with the most device time; the table goes
    to `path`."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA" or "cuda" in str(
                  e.device_type).lower()]
    kernel_ms = sum(e.self_device_time_total for e in events) / 1e3
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(prof.key_averages().table(
        sort_by="self_cuda_time_total", row_limit=40))
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
    return {"wall_ms": wall * 1e3, "kernel_ms": kernel_ms,
            "busy_share": kernel_ms / (wall * 1e3),
            "top_kernels": [(e.key[:80], e.self_device_time_total / 1e3)
                            for e in top]}


def seg_head_at_median(torch, seg, args, dev):
    """Random weights give every point of a frustum nearly the same logits
    (the 1024-wide global feature dominates), so the filter would keep all
    points or none. Zero logit 0 and move logit 1's bias to the median over
    the points of the frame's filtered detections (more than seg_pts_thr
    points; all detections are real here): half of them become
    foreground."""
    seen = []
    hook = seg.seg_net.register_forward_hook(
        lambda mod, inp, out: seen.append((out, inp[2])))
    seg.seg_point_masks(*args, device=dev)
    hook.remove()
    logits, valid = seen[0]
    used = valid & (valid.sum(-1, keepdim=True) > seg.seg_pts_thr)
    state = {k: v.clone() for k, v in seg.seg_net.state_dict().items()}
    state["seg_out.weight"][0] = 0.0
    state["seg_out.bias"][0] = 0.0
    state["seg_out.bias"][1] -= logits[..., 1][used].median()
    return {k: v.cpu() for k, v in state.items()}


def seg_margins(torch, seg, args):
    """The SEG masks on the CPU and, per detection, the least distance of
    a filtered point's foreground probability from a decision threshold."""
    seen = []
    hook = seg.seg_net.register_forward_hook(
        lambda mod, inp, out: seen.append((out, inp[2])))
    masks = seg.seg_point_masks(*args, device="cpu")
    hook.remove()
    logits, valid = seen[0]
    prob = torch.sigmoid(logits)
    gap = torch.minimum((prob[..., 1] - prob[..., 0]).abs(),
                        (prob[..., 1] - seg.seg_thr).abs())
    gap = torch.where(valid, gap, torch.full_like(gap, float("inf")))
    return masks, gap.amin(-1).numpy()


def seeker_phase(torch, profile=None, device="cuda"):
    """The Greedy Box Seeker on the card: FrustumProposerOG from the
    nuScenes seeker yaml at bench.py's shape (200k points, 96 detections
    loaded from per-camera COCO files through PreprocessedDetector),
    frames/s, host syncs per frame, peak memory (and under --profile the
    busy share and top kernels), held against the port's CPU run; then
    one frame each of the KITTI seeker (its yaml, a synthetic calibration,
    120k points, 32 detections through infer_kitti) and of the SEG seeker
    (random PointNet weights, seed 0) against their CPU runs. `device`
    names the card (another device only to rehearse the phase)."""
    from findnpropagate_torch import config as cfg_mod
    from findnpropagate_torch.models.frustum_pointnets import (
        PointNetInstanceSeg,
    )
    from findnpropagate_torch.openvocab import frustum_proposer as fp
    from findnpropagate_torch.openvocab import frustum_proposer_kitti as fk
    from findnpropagate_torch.openvocab.frustum_proposer_seg import (
        FrustumProposerSEG,
    )
    from findnpropagate_torch.openvocab.preprocessed_detector import (
        PreprocessedDetector,
    )

    out = {}
    dev = torch.device(device)
    work = ROOT / "build" / "seeker_dets"
    work.mkdir(parents=True, exist_ok=True)

    # ---- nuScenes, bench shape
    cfg = cfg_mod.cfg_from_yaml_file(str(ROOT / SEEKER_CFG))
    head = cfg.MODEL.DENSE_HEAD
    seeker = fp.FrustumProposerOG.from_config(head, cfg.CLASS_NAMES)
    (l2i, c2l, intr), pts, (boxes, labels, scores, cams), detector, images \
        = bench_seeker_frame(cfg.CLASS_NAMES, work)
    dets = detector.infer(images)
    if int(dets["det_mask"].sum()) != len(boxes):
        raise AssertionError("seeker: PreprocessedDetector lost detections")
    det_args = [dets[k] for k in ("det_boxes", "det_labels", "det_scores",
                                  "det_cams", "det_mask")]
    pts_d = torch.from_numpy(pts).to(dev)
    mask_d = torch.ones(len(pts), dtype=torch.bool, device=dev)
    mats_d = [torch.from_numpy(m).to(dev) for m in (l2i, c2l, intr)]

    def frame():
        return seeker.propose(pts_d, mask_d, *det_args, *mats_d,
                              device=dev)

    card = frame()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    med, times = frame_ms(torch, frame, SEEKER_REPS)
    # the frames' own peak, above what was allocated before them
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    syncs, copies, launches = runtime_calls(torch, frame, reps=3)
    out["nuscenes"] = {
        "points": len(pts), "dets": len(boxes), "ms_per_frame": med,
        "frames_per_s": 1e3 / med, "times_ms": times,
        "host_syncs_per_frame": syncs, "copies_per_frame": copies,
        "kernel_launches_per_frame": launches, "peak_mem_gb": peak}
    if profile:
        out["nuscenes"]["profile"] = profile_frame(
            torch, frame, str(profile) + ".seeker.txt")
    with Recorder(fp, "nms_normal_bev", torch) as rec:
        cpu = seeker.propose(pts, np.ones(len(pts), bool), *det_args,
                             l2i, c2l, intr, device="cpu")
    out["nuscenes"]["vs_cpu"] = hold_seeker(
        torch, "seeker nuScenes", card, cpu, top2_margins(torch, rec.calls))
    r = out["nuscenes"]
    log(f"seeker nuScenes ({len(pts)} points, {len(boxes)} dets): "
        f"{r['ms_per_frame']:.2f} ms/frame, {r['frames_per_s']:.2f} "
        f"frames/s (median of {SEEKER_REPS}), per frame {syncs:g} host "
        f"syncs, {copies:g} copy records (memcpy calls and transfers, any "
        f"direction), {launches:g} kernel launches; peak {peak:.3f} GiB; "
        f"card vs CPU "
        f"{r['vs_cpu']['valid']} valid of {r['vs_cpu']['dets']}, max box "
        f"err {r['vs_cpu']['max_box_err']:.3g}, oracle err "
        f"{r['vs_cpu']['max_oracle_err']:.3g}, "
        f"{len(r['vs_cpu']['exceptions'])} exceptions")
    if profile:
        p = r["profile"]
        log(f"seeker profile: wall {p['wall_ms']:.2f} ms, kernels "
            f"{p['kernel_ms']:.2f} ms, busy {p['busy_share']:.3f}; top "
            + "; ".join(f"{n} {t:.3f}" for n, t in p["top_kernels"]))
    if syncs > SEEKER_SYNCS:
        raise AssertionError(f"seeker: {syncs} host syncs per frame, want "
                             f"at most {SEEKER_SYNCS}")

    # ---- SEG on the same frame
    # torch's own initialisation from seed 0 (init_random_'s N(0, 0.05^2)
    # leaves every ReLU of the 1024-wide layers dead: constant logits)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = PointNetInstanceSeg(6)
    seg_args = (pts_d, mask_d, det_args[0], det_args[1], det_args[3],
                det_args[4], mats_d[0])
    seg = FrustumProposerSEG.from_config(head, cfg.CLASS_NAMES,
                                         seg_params=net.state_dict())
    seg = FrustumProposerSEG.from_config(
        head, cfg.CLASS_NAMES,
        seg_params=seg_head_at_median(torch, seg, seg_args, dev))
    masks_card = seg.seg_point_masks(*seg_args, device=dev).cpu()
    cpu_args = (pts, np.ones(len(pts), bool), *det_args)
    masks_cpu, gaps = seg_margins(
        torch, seg, (cpu_args[0], cpu_args[1], cpu_args[2], cpu_args[3],
                     cpu_args[5], cpu_args[6], l2i))
    exempt = {}
    for d in np.nonzero((masks_card != masks_cpu).any(-1).numpy())[0]:
        if not gaps[d] < SEG_MARGIN:
            raise AssertionError(f"seeker SEG: det {d} mask differs, least "
                                 f"probability margin {gaps[d]:.3g}")
        exempt[int(d)] = float(gaps[d])
    ms_seg, _ = frame_ms(torch, lambda: seg.propose(
        pts_d, mask_d, *det_args, *mats_d, device=dev), 3, warm=1)
    card = seg.propose(pts_d, mask_d, *det_args, *mats_d, device=dev)
    with Recorder(fp, "nms_normal_bev", torch) as rec:
        cpu = seg.propose(*cpu_args, l2i, c2l, intr, device="cpu")
    filtered = ~masks_cpu.all(-1)
    kept = int(masks_cpu[filtered].sum())
    if not filtered.any() or kept == 0:
        raise AssertionError("seeker SEG: the filter kept nothing or ran "
                             "on no detection")
    out["seg"] = {"ms_per_frame": ms_seg, "filtered_dets": int(
                      filtered.sum()), "kept_points": kept,
                  "mask_dets_differing": len(exempt),
                  "vs_cpu": hold_seeker(torch, "seeker SEG", card, cpu,
                                        top2_margins(torch, rec.calls),
                                        exempt)}
    r = out["seg"]
    log(f"seeker SEG: {ms_seg:.2f} ms/frame (median of 3), "
        f"{r['filtered_dets']} dets filtered ({kept} points kept), masks "
        f"differing card vs CPU in {len(exempt)} dets, "
        f"{r['vs_cpu']['valid']} valid, max box err "
        f"{r['vs_cpu']['max_box_err']:.3g}, "
        f"{len(r['vs_cpu']['exceptions'])} exceptions")

    # ---- KITTI, one frame
    kcfg = cfg_mod.cfg_from_yaml_file(str(ROOT / KITTI_SEEKER_CFG))
    kseeker = fk.FrustumProposerOGKITTI.from_config(kcfg.MODEL.DENSE_HEAD,
                                                    kcfg.CLASS_NAMES)
    rng = np.random.RandomState(1)
    n_k, d_k = KITTI_POINTS, KITTI_DETS
    kpts = np.stack([rng.uniform(0, 70.4, n_k), rng.uniform(-40, 40, n_k),
                     rng.uniform(-3, 1, n_k)], -1).astype(np.float32)
    kb = np.zeros((d_k, 4), np.float32)
    kb[:, 0] = rng.uniform(0, 1100, d_k)
    kb[:, 1] = rng.uniform(80, 280, d_k)
    kb[:, 2] = kb[:, 0] + rng.uniform(30, 140, d_k)
    kb[:, 3] = kb[:, 1] + rng.uniform(30, 90, d_k)
    write_coco(work / "kitti.json", "000042.png", kcfg.CLASS_NAMES, kb,
               rng.randint(1, 8, d_k), rng.uniform(0.2, 1.0, d_k))
    kd = PreprocessedDetector([work / "kitti.json"], kcfg.CLASS_NAMES,
                              box_fmt="xyxy", max_dets=d_k).infer_kitti(
        "000042")
    th = 0.004
    calib = (np.array(KITTI_P2, np.float32),
             np.array([[np.cos(th), -np.sin(th), 0],
                       [np.sin(th), np.cos(th), 0], [0, 0, 1]], np.float32),
             np.array(KITTI_V2C, np.float32))
    kargs = [kd[k] for k in ("det_boxes", "det_labels", "det_scores",
                             "det_mask")]
    kpts_d = torch.from_numpy(kpts).to(dev)
    kmask_d = torch.ones(n_k, dtype=torch.bool, device=dev)
    ms_k, _ = frame_ms(torch, lambda: kseeker.propose(
        kpts_d, kmask_d, *kargs, *calib, device=dev), 3, warm=1)
    card = kseeker.propose(kpts_d, kmask_d, *kargs, *calib, device=dev)
    with Recorder(fk, "nms_normal_bev", torch) as rec:
        cpu = kseeker.propose(kpts, np.ones(n_k, bool), *kargs, *calib,
                              device="cpu")
    out["kitti"] = {"points": n_k, "dets": d_k, "ms_per_frame": ms_k,
                    "vs_cpu": hold_seeker(torch, "seeker KITTI", card, cpu,
                                          top2_margins(torch, rec.calls))}
    r = out["kitti"]
    log(f"seeker KITTI ({n_k} points, {d_k} dets): {ms_k:.2f} ms/frame "
        f"(median of 3), {r['vs_cpu']['valid']} valid, max box err "
        f"{r['vs_cpu']['max_box_err']:.3g}, "
        f"{len(r['vs_cpu']['exceptions'])} exceptions")
    return out


ST_CFG = "tools/cfgs/nuscenes_models/transfusion_lidar_st.yaml"
ST_WORK = "build/st_smoke"
ST_SCENES = 8            # training frames, and the gt database's scenes
ST_EPOCHS = 2
ST_BATCH = 4             # the ST yaml's BATCH_SIZE_PER_GPU
# unknown classes the frustum store is seeded with: label in
# FULL_CLASS_NAMES (1-indexed) -> box size (dx, dy, dz)
ST_SEED_SIZES = {8: (1.8, 0.7, 1.2), 9: (0.8, 0.7, 1.7), 10: (0.4, 0.4, 1.0)}
ST_SEEDS_PER_FRAME = 6
ST_MIN_PTS = 5
# per extraction batch (an eval forward), as the main path's forward
EVAL_LAUNCHES = {"positions": 6, "posgather_conv": 16, "windowed_conv": 0,
                 "windowed_dw": 0}


def seed_unknown_boxes(store, frame_id, pts, gt_boxes, rng):
    """Save ST_SEEDS_PER_FRAME unknown-class boxes (ST_SEED_SIZES) centred
    on points of the frame beyond the ego vehicle, each holding ST_MIN_PTS
    points or more and overlapping no ground truth nor each other, under
    `frame_id`; returns how many."""
    from findnpropagate_torch.utils import geometry_np as G

    far = pts[np.hypot(pts[:, 0], pts[:, 1]) > 6.0]
    boxes, labels = [], []
    for _ in range(2000):
        lbl = int(rng.choice(list(ST_SEED_SIZES)))
        b = np.array([*far[rng.randint(len(far)), :3],
                      *ST_SEED_SIZES[lbl], rng.uniform(-np.pi, np.pi)],
                     np.float32)
        if (G.points_in_boxes_mask(pts[:, :3], b[None]).sum()
                >= ST_MIN_PTS and G.boxes_bev_iou_cpu(
                    b[None], gt_boxes).max() == 0
                and (not boxes or G.boxes_bev_iou_cpu(
                    b[None], np.stack(boxes)).max() == 0)):
            boxes.append(b)
            labels.append(lbl)
            if len(boxes) == ST_SEEDS_PER_FRAME:
                break
    store.save(frame_id, np.stack(boxes), rng.uniform(0.3, 0.9, len(boxes)),
               np.array(labels, np.int32))
    return len(boxes)


def st_inputs(cfg_mod, synth, work):
    """Phase 10's config and inputs under `work`: the ST yaml with the
    main path's backbone and bench.py's scenes, a gt database of 8 further
    scenes through build_shared_database, and a frustum store of
    unknown-class boxes on the training frames. Returns the config file,
    the store's folder and the boxes seeded per frame."""
    from findnpropagate_torch.datasets.augmentor.database_sampler import (
        build_shared_database,
    )
    from findnpropagate_torch.openvocab.pseudo_labels import PseudoLabelStore
    from findnpropagate_torch.utils import geometry_np as G

    cfg = cfg_mod.cfg_from_yaml_file(str(ROOT / ST_CFG))
    cfg.MODEL.BACKBONE_3D = cfg_mod.cfg_from_yaml_file(
        str(ROOT / CFG_FILE)).MODEL.BACKBONE_3D
    data = synth.bench_data_cfg(ST_SCENES, cfg)
    augs = [dict(a) for a in cfg.DATA_CONFIG.DATA_AUGMENTOR.AUG_CONFIG_LIST]
    gt_sampling = augs[0]
    assert gt_sampling["NAME"] == "gt_sampling"
    gt_sampling.update(USE_SHARED_MEMORY=True,
                       DB_DATA_PATH=["gt_database.npy"])
    data.update(DATASET="SyntheticDataset", DATA_PATH=str(work / "db"),
                DATA_AUGMENTOR=dict(cfg.DATA_CONFIG.DATA_AUGMENTOR,
                                    AUG_CONFIG_LIST=augs))
    cfg.DATA_CONFIG = data

    # gt database: the objects of 8 further scenes, rows of 5 features
    # (x, y, z relative to the box centre, intensity, a zero time lag)
    db = work / "db"
    (db / "gt_database").mkdir(parents=True, exist_ok=True)
    plain = dict(data, DATA_AUGMENTOR=None)
    more = synth.SyntheticDataset(cfg_mod.EDict(dict(plain, SYNTHETIC=dict(
        data["SYNTHETIC"], SEED=1000))), cfg.CLASS_NAMES, training=True)
    infos = {n: [] for n in cfg.CLASS_NAMES}
    for s in range(ST_SCENES):
        d = more.generate_scene(s)
        inside = G.points_in_boxes_mask(d["points"][:, :3], d["gt_boxes"])
        for k, (box, name) in enumerate(zip(d["gt_boxes"], d["gt_names"])):
            rows = np.zeros((int(inside[k].sum()), 5), np.float32)
            rows[:, :4] = d["points"][inside[k]]
            rows[:, :3] -= box[:3]
            rel = f"gt_database/{s}_{name}_{k}.bin"
            rows.tofile(db / rel)
            infos[str(name)].append({"name": str(name), "path": rel,
                                     "box3d_lidar": box.copy(),
                                     "num_points_in_gt": len(rows)})
    infos = build_shared_database(infos, db, db / "gt_database.npy")
    with open(db / gt_sampling["DB_INFO_PATH"][0], "wb") as f:
        pickle.dump(infos, f)

    # frustum store: unknown-class boxes centred on points of each training
    # frame beyond the ego vehicle, each holding ST_MIN_PTS points or more
    # and overlapping no ground truth
    train = synth.SyntheticDataset(cfg_mod.EDict(plain), cfg.CLASS_NAMES,
                                   training=True)
    store = PseudoLabelStore(work / "frustum")
    rng = np.random.RandomState(0)
    seeded = []
    for i in range(ST_SCENES):
        d = train.generate_scene(i)
        seeded.append(seed_unknown_boxes(store, i, d["points"],
                                         d["gt_boxes"], rng))
    path = work / "transfusion_lidar_st_smoke.yaml"
    path.write_text(json.dumps(cfg))      # JSON is YAML
    return path, work / "frustum", seeded


class STProbe:
    """The instruments of phase 10, swapped into the port's modules while
    train_st.main runs: each train step with its launches set to 0 just
    before and read just after, CUDA-event times, the wall time since the
    last step ended, the batch's pseudo boxes and copy-paste samples, the
    unknown-class targets of the head, each extraction batch's launches,
    the BN statistics around each extraction, the training dataset's
    host time, and the PseudoLoader the CLI builds."""

    def __init__(self, torch, tp, ws, profile=None,
                 profile_step=2 * ST_EPOCHS - 1):
        self.torch, self.tp, self.ws, self.profile = torch, tp, ws, profile
        self.profile_step = profile_step
        self.steps, self.extractions, self.eval_launches = [], [], []
        self.unknown_targets = []
        self.loader = self.detector = self.params = self.train_ds = None
        self.last_end = None
        self.sample_s = 0.0
        self.prof = self.prof_t0 = None
        self.busy = None

    def make_train_step(self, orig):
        def make(detector, tx, **kw):
            inner = orig(detector, tx, **kw)
            self.detector = detector

            def step(batch):
                return self.train_step(inner, batch)
            return step
        return make

    def train_step(self, inner, batch):
        torch = self.torch
        t_in = time.perf_counter()
        if self.params is None:
            self.params = [p.detach().clone()
                           for p in self.detector.parameters()]
        self.tp.reset_launches()
        self.ws.reset_launches()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        metrics = inner(batch)
        t1.record()
        torch.cuda.synchronize()
        now = time.perf_counter()
        launches = launches_now(self.tp, self.ws)
        m = {k: float(v) for k, v in metrics.items()}
        self.steps.append({
            "ms": t0.elapsed_time(t1),
            "wait_ms": None if self.last_end is None
            else (t_in - self.last_end) * 1e3,
            "iter_ms": None if self.last_end is None
            else (now - self.last_end) * 1e3,
            "loss": m["loss"], "grad_norm": m["grad_norm"],
            "overflow": m["sparse_window_overflow"],
            "launches": launches,
            "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
            "pseudo_per_frame": [int(n) for n in (
                batch["pseudo_boxes"][..., 7] > 0).sum(dim=1)],
            "copy_paste": int(batch["pseudo_samples_mask"].sum()),
            "unknown_targets": int(sum(self.unknown_targets)),
            "known_matches": sum(v for k, v in m.items()
                                 if k.endswith("_matches"))})
        self.unknown_targets.clear()
        if self.prof is not None:
            self.prof.__exit__(None, None, None)
            wall = (now - self.prof_t0) * 1e3
            events = [e for e in self.prof.key_averages()
                      if e.device_type.name == "CUDA"]
            kernel = sum(e.self_device_time_total for e in events) / 1e3
            self.busy = {"wall_ms": wall, "kernel_ms": kernel,
                         "busy_share": kernel / wall}
            Path(str(self.profile) + ".st.txt").write_text(
                self.prof.key_averages().table(
                    sort_by="self_cuda_time_total", row_limit=40))
            self.prof = None
        if (self.profile and len(self.steps) == self.profile_step
                and self.busy is None):
            # one epoch-1 iteration under the profiler: the wait for the
            # last batch and its step
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.prof_t0 = time.perf_counter()
        self.last_end = time.perf_counter()
        return metrics

    def make_eval_step(self, orig):
        def make(detector, **kw):
            inner = orig(detector, **kw)

            def step(batch):
                self.tp.reset_launches()
                self.ws.reset_launches()
                out = inner(batch)
                self.torch.cuda.synchronize()
                self.eval_launches.append(launches_now(self.tp, self.ws))
                return out
            return step
        return make

    def extract(self, orig):
        def run(detector, loader, *a, **kw):
            bn = {k: v.clone() for k, v in detector.named_buffers()}
            t0 = time.perf_counter()
            n = orig(detector, loader, *a, **kw)
            self.torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            changed = [k for k, v in detector.named_buffers()
                       if not self.torch.equal(v, bn[k])]
            self.extractions.append({"frames": n, "ms_per_frame":
                                     wall * 1e3 / max(n, 1),
                                     "bn_changed": changed,
                                     "training_after": detector.training})
            self.last_end = time.perf_counter()
            return n
        return run

    def hooks(self, orig):
        def register(loader):
            self.loader = loader
            return orig(loader)
        return register

    def targets(self, orig):
        def get_targets(head, res, gt):
            t = orig(head, res, gt)
            self.unknown_targets.append(t["unknown_mask"].sum())
            return t
        return get_targets

    def getitem(self, orig):
        def item(ds, index):
            t0 = time.perf_counter()
            try:
                return orig(ds, index)
            finally:
                if ds.data_augmentor is not None:
                    self.sample_s += time.perf_counter() - t0
                    self.train_ds = ds
        return item


def propagate_phase(torch, tp, ws, smi, profile=None):
    """Phase 10: self-training through the port's tools/train_st.py entry
    (main with arguments) at the ST yaml's full width, then the port's
    extraction loop on phase 9's bench frame; every gate checked here."""
    import findnpropagate_torch.datasets.synthetic as synth
    from findnpropagate_torch import config as cfg_mod
    from findnpropagate_torch.models.dense_heads.transfusion_head import (
        TransFusionHead,
    )
    from findnpropagate_torch.openvocab import frustum_proposer as fp
    from findnpropagate_torch.openvocab import self_training
    from findnpropagate_torch.openvocab.pseudo_labels import PseudoLabelStore
    from findnpropagate_torch.runtime import trainer
    from findnpropagate_torch.tools import extract_pseudo_labels as ex
    from findnpropagate_torch.tools import train_st

    work = ROOT / ST_WORK
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    cfg_path, frustum, seeded = st_inputs(cfg_mod, synth, work)
    inputs_s = time.perf_counter() - t0
    # the CLI runs in `work`: paths given relative to here are resolved
    probe = STProbe(torch, tp, ws, profile and Path(profile).resolve())
    cwd = Path.cwd()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        os.chdir(work)      # the CLI writes output/ under the working dir
        with Swap(trainer, "make_train_step",
                  probe.make_train_step(trainer.make_train_step)), \
                Swap(trainer, "make_eval_step",
                     probe.make_eval_step(trainer.make_eval_step)), \
                Swap(self_training, "extract_pseudo_labels",
                     probe.extract(self_training.extract_pseudo_labels)), \
                Swap(self_training, "register_pseudo_hooks",
                     probe.hooks(self_training.register_pseudo_hooks)), \
                Swap(TransFusionHead, "get_targets",
                     probe.targets(TransFusionHead.get_targets)), \
                Swap(synth.SyntheticDataset, "__getitem__",
                     probe.getitem(synth.SyntheticDataset.__getitem__)):
            rc = train_st.main([
                "--cfg_file", str(cfg_path), "--epochs", str(ST_EPOCHS),
                "--st_warmup", "1", "--st_interval", "1", "--seed", "0",
                "--pseudo_path", str(frustum), "--st_path",
                str(work / "st_labels")])
    finally:
        os.chdir(cwd)
    run_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    steps = probe.steps
    # ---- gates
    if rc != 0 or len(steps) != 2 * ST_EPOCHS:
        raise AssertionError(f"propagate: rc {rc}, {len(steps)} steps")
    for i, s in enumerate(steps):
        if s["launches"] != TRAIN_LAUNCHES:
            raise AssertionError(f"propagate step {i}: launches "
                                 f"{s['launches']}, want {TRAIN_LAUNCHES}")
        if not (math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])
                and s["grad_norm"] > 0 and s["overflow"] == 0):
            raise AssertionError(f"propagate step {i}: {s}")
        if sum(s["pseudo_per_frame"]) == 0:
            raise AssertionError(f"propagate step {i}: no pseudo box")
    if probe.eval_launches != [EVAL_LAUNCHES] * (ST_SCENES // ST_BATCH):
        raise AssertionError("propagate extraction launches "
                             f"{probe.eval_launches}, want {EVAL_LAUNCHES} "
                             f"per batch")
    changed = sum(bool((p.detach() != q).any()) for p, q in zip(
        probe.detector.parameters(), probe.params))
    if changed < 0.9 * len(probe.params):
        raise AssertionError(f"propagate: only {changed} of "
                             f"{len(probe.params)} parameters changed")
    queues = {lbl: len(q) for lbl, q in
              probe.loader.sampler.unknown_queue.items()}
    if not any(queues.values()):
        raise AssertionError("propagate: every copy-paste queue is empty")
    unknown = sum(s["unknown_targets"] for s in steps)
    if unknown <= 0:
        raise AssertionError("propagate: no unknown-class target reached "
                             "the loss")
    st = PseudoLabelStore(work / "st_labels")
    files = sorted((work / "st_labels").glob("*.npz"))
    if len(files) != ST_SCENES or st.stamped_epoch() != 1:
        raise AssertionError(f"propagate: {len(files)} self-train files, "
                             f"stamped {st.stamped_epoch()}")
    ext, = probe.extractions
    if ext["bn_changed"] or not ext["training_after"]:
        raise AssertionError(f"propagate: the extraction changed BN "
                             f"statistics {ext['bn_changed'][:3]} or left "
                             "eval mode on")
    st_pseudos = [len(st.load(i)[0]) for i in range(ST_SCENES)]
    # one training batch built again with nothing else running, then one
    # more under cProfile for the functions that take its host time
    ds = probe.train_ds
    t0 = time.perf_counter()
    ds.collate_batch([ds[i] for i in range(ST_BATCH)])
    alone_ms = (time.perf_counter() - t0) * 1e3
    prof = cProfile.Profile()
    prof.enable()
    ds.collate_batch([ds[i] for i in range(ST_BATCH)])
    prof.disable()
    loader_top = [(f"{Path(fn[0]).name}:{fn[1]}({fn[2]})", st[2] * 1e3)
                  for fn, st in sorted(pstats.Stats(prof).stats.items(),
                                       key=lambda kv: -kv[1][2])[:8]]
    for ck in (work / "output").rglob("ckpt"):
        shutil.rmtree(ck)

    # ---- the extraction CLI's frame loop on phase 9's bench frame
    scfg = cfg_mod.cfg_from_yaml_file(str(ROOT / SEEKER_CFG))
    seeker = fp.FrustumProposerOG.from_config(scfg.MODEL.DENSE_HEAD,
                                              scfg.CLASS_NAMES)
    (l2i, c2l, intr), pts, _, detector2d, images = bench_seeker_frame(
        scfg.CLASS_NAMES, work)
    frame = {"points": pts, "frame_id": "bench0", "camera_paths": images,
             "lidar2image": l2i, "camera2lidar": c2l,
             "camera_intrinsics": intr}

    class Frames(list):
        max_points = len(pts)

    store = PseudoLabelStore(work / "find")
    t0 = time.perf_counter()
    ex.extract_frames(Frames([frame]), seeker, detector2d, store,
                      device=torch.device("cuda"))
    find_ms = (time.perf_counter() - t0) * 1e3
    dev = torch.device("cuda")
    dets = detector2d.infer(images)
    ref = seeker.propose(
        torch.from_numpy(pts).to(dev),
        torch.ones(len(pts), dtype=torch.bool, device=dev),
        *[dets[k] for k in ("det_boxes", "det_labels", "det_scores",
                            "det_cams", "det_mask")],
        *[torch.from_numpy(m).to(dev) for m in (l2i, c2l, intr)], device=dev)
    valid = ref.valid.cpu().numpy()
    for got, want, name in zip(store.load("bench0"),
                               (ref.boxes, ref.scores, ref.labels),
                               ("boxes", "scores", "labels")):
        if not np.array_equal(got, want.cpu().numpy()[valid]):
            raise AssertionError(f"propagate: the extraction CLI's {name} "
                                 "differ from the seeker's valid proposals")

    e1 = [s for i, s in enumerate(steps) if i >= ST_EPOCHS]
    med = sorted(s["ms"] for s in e1)[len(e1) // 2]
    n_batches = len(steps)
    out = {
        "device": smi, "inputs_s": inputs_s, "run_s": run_s,
        "seeded_per_frame": seeded, "steps": steps,
        "ms_per_step_epoch1": med,
        "iter_ms": [s["iter_ms"] for s in steps],
        "wait_ms": [s["wait_ms"] for s in steps],
        "loader_host_ms_per_batch": probe.sample_s * 1e3 / n_batches,
        "loader_alone_ms_per_batch": alone_ms,
        "loader_top_self_ms": loader_top,
        "extraction_ms_per_frame": ext["ms_per_frame"],
        "pseudo_per_frame": [s["pseudo_per_frame"] for s in steps],
        "copy_paste_per_batch": [s["copy_paste"] for s in steps],
        "unknown_targets": [s["unknown_targets"] for s in steps],
        "queues": queues, "selftrain_boxes_per_frame": st_pseudos,
        "peak_mem_gb": peak, "find_ms": find_ms,
        "find_valid": int(valid.sum()), "busy": probe.busy}
    log(f"propagate ({smi}): inputs {inputs_s:.1f} s, train_st.main "
        f"{run_s:.1f} s; {med:.1f} ms per self-training step (median of "
        f"epoch 1, CUDA events), steps "
        f"{[round(s['ms'], 1) for s in steps]} ms, wall per iteration "
        f"{[None if t is None else round(t, 1) for t in out['iter_ms']]} ms "
        f"(waits {[None if t is None else round(t, 1) for t in out['wait_ms']]}"
        f"), loader host {out['loader_host_ms_per_batch']:.1f} ms per batch "
        f"(data_time; {alone_ms:.1f} alone after the run), extraction {ext['ms_per_frame']:.1f} ms/frame, peak "
        f"{peak:.2f} GiB")
    log(f"propagate ({smi}): pseudo boxes per frame {out['pseudo_per_frame']}"
        f", copy-paste samples per batch {out['copy_paste_per_batch']}, "
        f"unknown targets per step {out['unknown_targets']}, queues "
        f"{queues}, self-train boxes per frame {st_pseudos}, losses "
        f"{[round(s['loss'], 3) for s in steps]}, launches per step "
        f"{steps[0]['launches']}, per extraction batch "
        f"{probe.eval_launches[0]}; extraction CLI on the bench frame "
        f"{find_ms:.1f} ms, {out['find_valid']} valid proposals = the "
        "seeker's")
    log(f"propagate ({smi}): one training batch's host time under "
        "cProfile, the functions with the most self time (ms): " + "; ".join(
            f"{n} {t:.1f}" for n, t in loader_top))
    if probe.busy:
        log(f"propagate profile ({smi}): one epoch-1 iteration wall "
            f"{probe.busy['wall_ms']:.1f} ms, kernels "
            f"{probe.busy['kernel_ms']:.1f} ms, busy "
            f"{probe.busy['busy_share']:.3f}")
    out["launches_per_step"] = steps[0]["launches"]
    out["launches_per_extraction_batch"] = probe.eval_launches[0]
    return out, probe.detector, cfg_path, frustum


OV_MODES = ("GLIP", "CROP", "MASKCLIP")
# the stand-ins' embedding width (CLIP ViT-B/32's) and MaskCLIP's patch grid
OV_EMBED = 512
OV_GRID = 7
# The card's relabel against the port's CPU run on the same frame: labels
# equal and scores within OV_TOL, but for a box whose CPU and card scores
# lie within OV_TOL (its two best classes tie within it; printed). The
# class scores are f32 sums (IoU products, crop features, per-pixel
# probabilities) taken in another order on the card.
OV_TOL = 1e-5
OV_ENSEMBLE = {"IOU_THRESH": 0.1, "NMS_THRESH": 0.1,
               "MEMORY_VOTING": {"ENABLED": True, "IGNORE_THRESH": 2,
                                 "RM_THRESH": 3}}
# alt mode on the bench frame: seeded ground truths, and CLIP2Scene's
# clustering at a radius the bench cloud's density (4.3 points per m^3)
# can hold
OV_GT = 24
OV_SEG_PARAMS = {"eps": 1.0, "min_samples": 5}
OV_HDBSCAN_SUBSET = 4000
OV_RECALL_LOW = (0.01, 0.1)


class ClipStandIn:
    """A seeded stand-in for CLIP's image tower (its weights are not in
    the repository): each 224 crop's 7x7 grid of 32x32 patch means through
    a seeded (147, 512) projection."""

    def __init__(self, torch, weight):
        self.torch, self.weight = torch, weight

    def get_image_features(self, pixel_values):
        p = self.torch.nn.functional.avg_pool2d(pixel_values, 32)
        return p.reshape(len(p), -1) @ self.weight


def dense_stand_in(torch, weight):
    """MaskCLIP's dense encoder, a seeded stand-in: 14x14 cell means of
    each image grouped 2x2 into a 7x7 grid of 12 values, through a seeded
    (12, 512) projection."""
    def encode(images):
        b = images.shape[0]
        p = torch.nn.functional.adaptive_avg_pool2d(
            images.permute(0, 3, 1, 2), 2 * OV_GRID)
        p = p.reshape(b, 3, OV_GRID, 2, OV_GRID, 2).permute(
            0, 2, 4, 1, 3, 5).reshape(b, OV_GRID, OV_GRID, 12)
        return p @ weight
    return encode


def hold_relabel(label, card, cpu):
    """The card's (labels, scores) against the CPU's (see OV_TOL): the
    comparison's numbers and its exceptions."""
    cl, cs = card
    hl, hs = cpu
    gap = np.abs(cs - hs)
    if not (gap <= OV_TOL).all():
        raise AssertionError(f"{label}: card and CPU scores differ by "
                             f"{gap.max():.3g} > {OV_TOL}")
    diff = np.flatnonzero(cl != hl)
    for b in diff:
        log(f"  {label} exception: box {b} label {cl[b]} on the card, "
            f"{hl[b]} on the CPU (scores {cs[b]:.7f} / {hs[b]:.7f})")
    return {"boxes": len(cl), "max_score_err": float(gap.max(initial=0.0)),
            "label_exceptions": len(diff)}


def seg_labels_of(pts, gt, class_names):
    """Seeded CLIP2Scene per-point labels: a point in a ground truth takes
    its class's CLIP2Scene label, the others a background label."""
    from findnpropagate_torch.openvocab.alt_proposers import (
        CLASSES_NUSCENES_SEG,
    )
    from findnpropagate_torch.utils import geometry_np as G

    rng = np.random.RandomState(1)
    seg = rng.randint(11, len(CLASSES_NUSCENES_SEG) + 1, len(pts))
    inside = G.points_in_boxes_mask(pts[:, :3], gt[:, :7])
    for k, row in enumerate(gt):
        name = class_names[int(row[7]) - 1]
        seg[inside[k]] = CLASSES_NUSCENES_SEG.index(name) + 1
    return seg


def open_vocab_phase(torch, tp, ws, smi, detector, cfg_path, frustum,
                     device="cuda"):
    """Phase 11: phase 10's model relabeled through build_relabeler in the
    extraction (GLIP, CROP, MASKCLIP), the memory ensembles and the
    known / unknown recall over the stored labels, and the extraction
    CLI's alt mode on phase 9's bench frame; every gate checked here.
    `device` names the card (another device only to rehearse the phase)."""
    from findnpropagate_torch import config as cfg_mod
    from findnpropagate_torch.models.post_processing import recall_record
    from findnpropagate_torch.openvocab import alt_proposers, self_training
    from findnpropagate_torch.openvocab.box_classification import (
        CLIPBoxClassification,
    )
    from findnpropagate_torch.openvocab.pseudo_labels import (
        PseudoLabelStore,
        PseudoLoader,
        PseudoProcessor,
    )
    from findnpropagate_torch.runtime import trainer
    from findnpropagate_torch.tools import extract_pseudo_labels as ex
    from findnpropagate_torch.tools import train_st
    from findnpropagate_torch.utils import memory_ensemble as me
    from findnpropagate_torch.utils.clustering import hdbscan

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cpu = torch.device("cpu")
    work = ROOT / ST_WORK / "open_vocab"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cfg = cfg_mod.cfg_from_yaml_file(str(cfg_path))
    known = list(cfg.KNOWN_CLASS_NAMES)
    full = list(cfg.FULL_CLASS_NAMES)
    hooks = self_training.register_pseudo_hooks(PseudoLoader(
        known, pseudo_path=str(frustum), self_train_path=str(work / "none"),
        all_class_names=full))
    dataset, loader = train_st.inference_loader(cfg, ST_BATCH, hooks,
                                                prefetch=0)
    # phase 9's rig and per-camera COCO files (labels in the 10 classes)
    (l2i, _, _), pts, _, detector2d, image_names = bench_seeker_frame(
        full, work)
    gen = torch.Generator().manual_seed(0)
    w_img = torch.randn(147, OV_EMBED, generator=gen) / 147 ** 0.5
    w_dense = torch.randn(12, OV_EMBED, generator=gen) / 12 ** 0.5
    text = torch.randn(len(full), OV_EMBED, generator=gen)
    text = text / text.norm(dim=-1, keepdim=True)

    class Rigged:
        """The extraction's batches with the keys the relabelers read."""

        def __iter__(self):
            for batch in loader:
                n = len(batch["frame_id"])
                batch["lidar2image"] = np.repeat(l2i[None], n, axis=0)
                batch["camera_paths"] = [image_names] * n
                yield batch

    def frame_images(batch, i, where=dev):
        """Six seeded 900x1600 images of the frame, in [0, 1]."""
        g = torch.Generator(device=dev).manual_seed(
            1000 + int(batch["frame_id"][i]))
        return torch.rand((6, 900, 1600, 3), generator=g,
                          device=dev).to(where)

    def relabeler(mode, where):
        opt = dict(cfg.OPTIMIZATION, CLIP_UNK_RELABEL=True, CLIP_TYPE=mode)
        r = self_training.build_relabeler(
            opt, full, detector2d=detector2d, device=where,
            image_provider=lambda b, i: frame_images(b, i, where))
        if isinstance(r.vlm, CLIPBoxClassification):
            r.vlm._model = ClipStandIn(torch, w_img.to(where))
            r.vlm._text_features = text.to(where)
        elif mode == "MASKCLIP":
            r.vlm.maskclip._encode_dense = dense_stand_in(torch,
                                                          w_dense.to(where))
            r.vlm.maskclip._text_features = text.to(where)
        return r

    def extract(name, relabel=None):
        eval_launches, calls = [], []

        def make_eval(orig):
            def make(det, **kw):
                inner = orig(det, **kw)

                def step(batch):
                    tp.reset_launches()
                    ws.reset_launches()
                    out = inner(batch)
                    if cuda:
                        torch.cuda.synchronize()
                    eval_launches.append(launches_now(tp, ws))
                    return out
                return step
            return make

        def spy(b, batch, i, lab, sc):
            if cuda:
                torch.cuda.synchronize()
                ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
                ev[0].record()
            t0 = time.perf_counter()
            out = relabel(b, batch, i, lab, sc)
            wall = (time.perf_counter() - t0) * 1e3
            if cuda:
                ev[1].record()
                ev[1].synchronize()
            calls.append({"ms": ev[0].elapsed_time(ev[1]) if cuda else wall,
                          "wall_ms": wall, "args": (b, batch, i, lab, sc),
                          "out": out})
            return out

        proc = PseudoProcessor(known, self_training_folder=work / name,
                               all_class_names=full)
        with Swap(trainer, "make_eval_step",
                  make_eval(trainer.make_eval_step)):
            n = self_training.extract_pseudo_labels(
                detector, Rigged(), proc, epoch=1,
                relabeler=None if relabel is None else spy)
        want = [EVAL_LAUNCHES] * (ST_SCENES // ST_BATCH)
        if n != ST_SCENES or (cuda and eval_launches != want):
            raise AssertionError(f"open vocab {name}: {n} frames, launches "
                                 f"{eval_launches}, want {want}")
        return PseudoLabelStore(work / name), calls, eval_launches

    out = {"device": smi}
    t_phase = time.perf_counter()
    plain, _, launches = extract("plain")
    plain_labels = [plain.load(i)[2] for i in range(ST_SCENES)]
    out["launches_per_extraction_batch"] = launches[0] if launches else None
    stores = {"plain": plain}
    for mode in OV_MODES:
        relabel = relabeler(mode, dev)
        if cuda:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        store, calls, _ = extract(mode.lower(), relabel)
        peak = ((torch.cuda.max_memory_allocated() - base) / 2 ** 30
                if cuda else None)
        stores[mode] = store
        changed = sum(int((store.load(i)[2] != plain_labels[i]).sum())
                      for i in range(ST_SCENES))
        if len(calls) != ST_SCENES or not changed:
            raise AssertionError(f"open vocab {mode}: {len(calls)} relabel "
                                 f"calls, {changed} labels changed")
        # one frame on the card against the port's CPU run
        first = calls[0]
        b, batch, i, lab, sc = first["args"]
        held = hold_relabel(mode, first["out"],
                            relabeler(mode, cpu)(b, batch, i, lab, sc))
        syncs = copies = None
        if cuda:
            syncs, copies, _ = runtime_calls(
                torch, lambda: relabel(b, batch, i, lab, sc), reps=2)
        ms = sorted(c["ms"] for c in calls)
        out[mode] = {"ms_per_frame": ms[len(ms) // 2],
                     "ms_per_frame_all": [c["ms"] for c in calls],
                     "wall_ms_per_frame_all": [c["wall_ms"] for c in calls],
                     "boxes_per_frame": [len(c["out"][0]) for c in calls],
                     "labels_changed": changed, "card_vs_cpu": held,
                     "syncs_per_call": syncs, "h2d_copies_per_call": copies,
                     "peak_mem_gb": peak}
        log(f"open vocab {mode} ({smi}): relabel "
            f"{out[mode]['ms_per_frame']:.2f} ms/frame (median of "
            f"{len(calls)}, {ms[0]:.2f}-{ms[-1]:.2f}), "
            f"{out[mode]['boxes_per_frame']} boxes per frame, {changed} "
            f"stored labels changed, {syncs} host syncs and {copies} "
            f"host-to-device copies per call, peak "
            f"{peak if peak is None else round(peak, 3)} GiB; card vs CPU "
            f"on frame {i}: {held}")

    # ---- ensembles and recall over the stored labels, card against CPU
    def rows(store, i):
        boxes, scores, labels = store.load(i)
        return np.concatenate([boxes[:, :7], labels[:, None].astype(
            np.float32), scores[:, None]], 1).astype(np.float32)

    rng = np.random.RandomState(0)
    ens = {}
    for i in range(ST_SCENES):
        a = {"gt_boxes": rows(plain, i), "cls_scores": None,
             "iou_scores": None}
        a["memory_counter"] = rng.randint(0, 3, len(a["gt_boxes"]))
        b = {"gt_boxes": rows(stores["GLIP"], i), "cls_scores": None,
             "iou_scores": None}
        b["memory_counter"] = np.zeros(len(b["gt_boxes"]), np.int64)
        for name in ("consistency_ensemble", "nms_ensemble",
                     "bipartite_ensemble"):
            c = dict(OV_ENSEMBLE, NAME=name)
            got = me.memory_ensemble(a, b, c, device=dev)
            want = me.memory_ensemble(a, b, c, device=cpu)
            for k, v in want.items():
                if v is not None and not np.array_equal(got[k], v):
                    raise AssertionError(f"memory_ensemble {name} frame {i}"
                                         f": {k} differs card / CPU")
            ens.setdefault(name, []).append(len(got["gt_boxes"]))
    out["ensemble_boxes_per_frame"] = ens
    known_labels = tuple(range(1, len(known) + 1))
    post = cfg.MODEL.POST_PROCESSING
    # the yaml's IoU thresholds, and two low ones: a model of 4 steps from
    # random weights reaches few ground truths at 0.3
    thresh = OV_RECALL_LOW + tuple(post.RECALL_THRESH_LIST)
    fr = PseudoLabelStore(frustum)
    recall = {}
    for name, store in stores.items():
        acc = {}
        for i in range(ST_SCENES):
            gt = np.asarray(dataset[i]["gt_boxes"], np.float32)
            fb, _, fl = fr.load(i)
            # (box, label) rows: the frame's known-class ground truths
            # (label last) and its unknown-class frustum boxes
            gt = np.concatenate([np.concatenate([gt[:, :7], gt[:, -1:]], 1),
                                 np.concatenate([fb[:, :7], fl[:, None]], 1)]
                                ).astype(np.float32)
            boxes, scores, _ = store.load(i)
            args = (boxes[:, :7], scores >= float(post.SCORE_THRESH), gt)
            recs = [recall_record(*[torch.from_numpy(np.ascontiguousarray(
                x)).to(d) for x in args], thresh, known_labels)
                for d in (dev, cpu)]
            for k in recs[1]:
                if int(recs[0][k]) != int(recs[1][k]):
                    raise AssertionError(f"recall_record {name} frame {i}: "
                                         f"{k} differs card / CPU")
                acc[k] = acc.get(k, 0) + int(recs[1][k])
        recall[name] = acc
    out["recall"] = recall
    log(f"open vocab ({smi}): memory ensembles (plain then GLIP labels) "
        f"boxes per frame {ens}, card = CPU; recall (scores >= "
        f"{post.SCORE_THRESH}, known {known_labels}) " + "; ".join(
            f"{n}: " + ", ".join(f"{k} {v}" for k, v in r.items())
            for n, r in recall.items()))

    # ---- the extraction CLI's alt mode on the bench frame
    grng = np.random.RandomState(2)
    gt = np.zeros((OV_GT, 8), np.float32)
    gt[:, :2] = grng.uniform(-40, 40, (OV_GT, 2))
    gt[:, 2] = grng.uniform(-2, 0, OV_GT)
    gt[:, 7] = grng.randint(1, len(full) + 1, OV_GT)
    from findnpropagate_torch.openvocab.frustum_proposer import (
        NUSCENES_ANCHORS,
    )
    gt[:, 3:6] = NUSCENES_ANCHORS[gt[:, 7].astype(int) - 1]
    gt[:, 6] = grng.uniform(-np.pi, np.pi, OV_GT)
    frame = {"points": pts, "frame_id": "bench0", "camera_paths":
             image_names, "lidar2image": l2i, "gt_boxes": gt,
             "point_seg_labels": seg_labels_of(pts, gt, full)}

    class Frames(list):
        max_points = len(pts)

    pooled = []
    orig_hdbscan = alt_proposers._hdbscan

    def hd_spy(feats, *a, **kw):
        pooled.append(feats)
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        labels = orig_hdbscan(feats, *a, **kw)
        pooled.append((time.perf_counter() - t0) * 1e3)
        return labels

    alt = {}
    for name in alt_proposers.ALT_PROPOSER_REGISTRY:
        head = cfg_mod.EDict({"NAME": name, "PARAMS": OV_SEG_PARAMS
                              if name.startswith("CLIP2Scene") else {}})
        proposer = ex.build_alt_proposer(head, full, device=dev)
        store = PseudoLabelStore(work / f"alt_{name}")
        t0 = time.perf_counter()
        with Swap(alt_proposers, "_hdbscan", hd_spy):
            recalled, total = ex.extract_frames(
                Frames([frame]), proposer, detector2d, store, device=dev,
                alt=name)
        ms = (time.perf_counter() - t0) * 1e3
        if not (work / f"alt_{name}" / "bench0.npz").exists():
            raise AssertionError(f"alt mode {name}: no store written")
        boxes, scores, labels = store.load("bench0")
        if not (np.isfinite(boxes).all() and np.isfinite(scores).all()):
            raise AssertionError(f"alt mode {name}: non-finite boxes")
        alt[name] = {"ms_per_frame": ms, "boxes": len(boxes),
                     "recalled": recalled, "gt": total}
    feats, hd_ms = pooled[0], pooled[1]
    sub = feats[:OV_HDBSCAN_SUBSET]
    same = np.array_equal(hdbscan(sub, 5, device=dev),
                          hdbscan(sub, 5, device=cpu))
    if not same:
        raise AssertionError("HDBSCAN: the card's labels differ from the "
                             "CPU's")
    out["alt"] = alt
    out["hdbscan_points"] = len(feats)
    out["hdbscan_ms"] = hd_ms
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"open vocab alt mode ({smi}), bench frame (200k points, 96 "
        "detections): " + "; ".join(
            f"{n} {a['ms_per_frame']:.0f} ms, {a['boxes']} boxes"
            for n, a in alt.items()) + f"; FrustumProposer's HDBSCAN over "
        f"{len(feats)} pooled points in {hd_ms:.0f} ms (spanning tree on "
        f"the card; labels of the first {len(sub)} equal to the CPU's); "
        f"phase {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------- the paper's yaml as written

PAPER_WORK = "build/st_paper"
# key frames of the nuScenes tree: the first is scene 0 (every 8th scene is
# val), the others scene 1 (train); CBGS resamples the train frames ~6x
PAPER_FRAMES = 3
PAPER_POINTS = 200000      # bench.py's lidar_ring scenes
# each of the MAX_SWEEPS - 1 sweeps before a key frame: 200k + 9 x 11,111
# points fill MAX_POINTS (300,000), as ten real sweeps of ~35k do
PAPER_SWEEP_PTS = 11111
NUS_VERSION = "v1.0-trainval"          # the yaml's VERSION
NUS_DB = "nuscenes_dbinfos_10sweeps_withvelo.pkl"   # the yaml's DB_INFO_PATH
NUS_GENERAL = {
    "car": "vehicle.car", "truck": "vehicle.truck",
    "construction_vehicle": "vehicle.construction",
    "bus": "vehicle.bus.rigid", "trailer": "vehicle.trailer",
    "barrier": "movable_object.barrier", "motorcycle": "vehicle.motorcycle",
    "bicycle": "vehicle.bicycle", "pedestrian": "human.pedestrian.adult",
    "traffic_cone": "movable_object.trafficcone"}
# the narrow gather-mode model on the card against the CPU: float32 on both
# sides (the sparse products are full f32 with matmul's TF32 off, PyTorch's
# default; cuDNN's TF32 is turned off for the check), sums in another
# order: 1e-4 relative
GATHER_REF_RTOL = 1e-4
# the same model under PyTorch's default flags, as train_st runs it: cuDNN
# may take the dense convs (L2+, BEV, head) in TF32, two roundings of 2^-11
# (an NVIDIA H100 80GB HBM3 at 700 W read 3.6e-6 and 9.0e-8)
GATHER_REF_TF32_RTOL = 1e-3
# one batch through the gathers of paper_step_pair: the same forward, f32
# sums (voxel means, BN statistics) in another order
GATHER_LOSS_RTOL = 1e-5
PAPER_KITTI_FRAMES = 2
GATHER_LAUNCHES = {"positions": 0, "posgather_conv": 0, "windowed_conv": 0,
                   "windowed_dw": 0}


@contextlib.contextmanager
def tf32_off(torch):
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def write_nuscenes_tree(root, scenes, max_sweeps, rng):
    """A nuScenes release in its own layout under `root`: the NUS_VERSION
    JSON tables as tests/test_dataset_bootstrap.py writes them, key frames
    under samples/LIDAR_TOP and their sweeps under sweeps/LIDAR_TOP, bins
    of 5 features. `scenes`: per scene its key frames (points (N, 4), boxes
    (M, 7), detection class names) in the lidar frame. Each key frame ends
    a chain of max_sweeps - 1 sweeps of PAPER_SWEEP_PTS of its points, 0.05
    s apart, the ego driving along +x at 10 m/s, the lidar 1.84 m above
    it; annotations in the global frame with their category through
    instance -> category and their lidar point counts."""
    from findnpropagate_torch.utils import geometry_np as G

    t = {k: [] for k in ("scene", "sample", "sample_data", "ego_pose",
                         "calibrated_sensor", "sample_annotation",
                         "instance", "attribute", "category")}
    cs_t = np.array([0.94, 0.0, 1.84])
    ident = [1.0, 0.0, 0.0, 0.0]
    t["calibrated_sensor"].append({"token": "lidar_top",
                                   "translation": cs_t.tolist(),
                                   "rotation": ident, "camera_intrinsic": []})
    t["category"] = [{"token": f"cat_{n}", "name": g}
                     for n, g in NUS_GENERAL.items()]
    for d in ("samples", "sweeps"):
        (root / d / "LIDAR_TOP").mkdir(parents=True, exist_ok=True)
    ts, n_ann = 1_533_151_600_000_000, 0
    for s, frames in enumerate(scenes):
        t["scene"].append({"token": f"scene{s}", "name": f"scene-{s:04d}"})
        prev_sd = prev_sample = ""
        for k, (pts, boxes, names) in enumerate(frames):
            sample = f"s{s}_{k}"
            key_ego = np.array([100.0 + 200 * s + 20 * k, 300.0, 0.0])
            for w in range(max_sweeps):
                ts += 50_000
                key = w == max_sweeps - 1
                ego = key_ego - [0.5 * (max_sweeps - 1 - w), 0.0, 0.0]
                sd = f"n{s}_{k}" if key else f"n{s}_{k}_{w}"
                rows = np.zeros((len(pts) if key else PAPER_SWEEP_PTS, 5),
                                np.float32)
                if key:
                    rows[:, :4] = pts
                else:     # in this sweep's own lidar frame
                    rows[:, :4] = pts[rng.choice(len(pts), PAPER_SWEEP_PTS,
                                                 replace=False)]
                    rows[:, :3] -= (ego - key_ego).astype(np.float32)
                fname = f"{'samples' if key else 'sweeps'}/LIDAR_TOP/{sd}.bin"
                rows.tofile(root / fname)
                t["ego_pose"].append({"token": f"pose_{sd}", "timestamp": ts,
                                      "translation": ego.tolist(),
                                      "rotation": ident})
                t["sample_data"].append({
                    "token": sd, "sample_token": sample,
                    "ego_pose_token": f"pose_{sd}",
                    "calibrated_sensor_token": "lidar_top",
                    "timestamp": ts, "filename": fname, "prev": prev_sd,
                    "next": "", "is_key_frame": key})
                if prev_sd:
                    t["sample_data"][-2]["next"] = sd
                prev_sd = sd
            t["sample"].append({"token": sample, "timestamp": ts,
                                "scene_token": f"scene{s}",
                                "data": {"LIDAR_TOP": prev_sd},
                                "prev": prev_sample, "next": ""})
            if prev_sample:
                t["sample"][-2]["next"] = sample
            prev_sample = sample
            counts = G.points_in_boxes_mask(pts[:, :3], boxes).sum(axis=1)
            for b, name, n_pts in zip(boxes, names, counts):
                t["instance"].append({"token": f"inst{n_ann}",
                                      "category_token": f"cat_{name}"})
                t["sample_annotation"].append({
                    "token": f"ann{n_ann}", "sample_token": sample,
                    "instance_token": f"inst{n_ann}",
                    "translation": (b[:3] + cs_t + key_ego).tolist(),
                    "size": [float(b[4]), float(b[3]), float(b[5])],
                    "rotation": [float(np.cos(b[6] / 2)), 0.0, 0.0,
                                 float(np.sin(b[6] / 2))],
                    "num_lidar_pts": int(n_pts), "num_radar_pts": 0,
                    "prev": "", "next": "", "attribute_tokens": []})
                n_ann += 1
    (root / NUS_VERSION).mkdir(parents=True, exist_ok=True)
    for name, rows in t.items():
        (root / NUS_VERSION / f"{name}.json").write_text(json.dumps(rows))
    return {k: len(v) for k, v in t.items()}


def paper_inputs(cfg_mod, synth, work):
    """The nuScenes tree of the paper phase under work/nuscenes (bench.py's
    200k-point lidar_ring scenes with objects of all 10 classes), its infos
    and gt database through the port's create_nuscenes_infos /
    create_groundtruth_database (the database under the yaml's name), and
    a frustum store of unknown-class boxes on each train frame."""
    from findnpropagate_torch.datasets import nuscenes_infos
    from findnpropagate_torch.openvocab.pseudo_labels import PseudoLabelStore

    cfg = cfg_mod.cfg_from_yaml_file(str(ROOT / ST_CFG))
    full = list(cfg.FULL_CLASS_NAMES)
    gen = synth.SyntheticDataset(cfg_mod.EDict(dict(
        synth.bench_data_cfg(PAPER_FRAMES, cfg), DATA_AUGMENTOR=None,
        SYNTHETIC=dict(NUM_SCENES=PAPER_FRAMES, NUM_OBJECTS=40,
                       NUM_RAW_POINTS=PAPER_POINTS, PATTERN="lidar_ring",
                       SEED=2000))), full)
    frames = [gen.generate_scene(i) for i in range(PAPER_FRAMES)]
    frames = [(d["points"], d["gt_boxes"], d["gt_names"]) for d in frames]
    root = work / "nuscenes"
    rng = np.random.RandomState(0)
    tables = write_nuscenes_tree(root, [frames[:1], frames[1:]],
                                 int(cfg.DATA_CONFIG.MAX_SWEEPS), rng)
    out = nuscenes_infos.create_nuscenes_infos(
        root, version=NUS_VERSION, max_sweeps=int(cfg.DATA_CONFIG.MAX_SWEEPS))
    db = nuscenes_infos.create_groundtruth_database(root, out["train"])
    db.rename(root / NUS_DB)
    store = PseudoLabelStore(work / "frustum")
    seeded = [seed_unknown_boxes(store, f"n1_{k}", pts, boxes, rng)
              for k, (pts, boxes, _) in enumerate(frames[1:])]
    return root, out, tables, seeded


def paper_kitti_check(torch, cfg_mod, work):
    """The extraction CLI's KITTI mode through KittiDataset: a KITTI tree
    (velodyne, label_2, calib, ImageSets; PAPER_KITTI_FRAMES frames of
    KITTI_POINTS points, 3 cars and KITTI_DETS cached 2D boxes each, phase
    9's calibration), its infos through create_kitti_infos, the CLI's main
    on the card and on the CPU: per frame the same proposals, labels
    equal, boxes within SEEKER_BOX_ATOL, scores within
    SEEKER_ORACLE_ATOL."""
    from findnpropagate_torch.datasets.kitti import create_kitti_infos
    from findnpropagate_torch.openvocab.pseudo_labels import PseudoLabelStore
    from findnpropagate_torch.tools import extract_pseudo_labels as ex
    from findnpropagate_torch.utils.calibration_kitti import Calibration

    kcfg = cfg_mod.cfg_from_yaml_file(str(ROOT / KITTI_SEEKER_CFG))
    root = work / "kitti"
    for d in ("velodyne", "label_2", "calib"):
        (root / "training" / d).mkdir(parents=True, exist_ok=True)
    (root / "ImageSets").mkdir(exist_ok=True)
    ids = [f"{i:06d}" for i in range(PAPER_KITTI_FRAMES)]
    (root / "ImageSets" / "train.txt").write_text("\n".join(ids) + "\n")
    th = 0.004
    r0 = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                   [0, 0, 1]], np.float32)
    calib = Calibration({"P2": np.array(KITTI_P2, np.float32), "R0": r0,
                         "Tr_velo2cam": np.array(KITTI_V2C, np.float32)})
    flat = lambda a: " ".join(f"{v:.6g}" for v in np.ravel(a))  # noqa: E731
    rng = np.random.RandomState(3)
    preds = []
    for fid in ids:
        (root / "training" / "calib" / f"{fid}.txt").write_text(
            f"P0: {flat(np.zeros(12))}\nP1: {flat(np.zeros(12))}\n"
            f"P2: {flat(KITTI_P2)}\nP3: {flat(np.zeros(12))}\n"
            f"R0_rect: {flat(r0)}\nTr_velo_to_cam: {flat(KITTI_V2C)}\n")
        pts = np.stack([rng.uniform(0, 70.4, KITTI_POINTS),
                        rng.uniform(-40, 40, KITTI_POINTS),
                        rng.uniform(-3, 1, KITTI_POINTS),
                        rng.uniform(0, 1, KITTI_POINTS)], -1)
        pts.astype(np.float32).tofile(root / "training" / "velodyne"
                                      / f"{fid}.bin")
        lines = []
        for _ in range(3):
            x, y = rng.uniform(8, 40), rng.uniform(-10, 10)
            bottom = calib.lidar_to_rect(np.array([[x, y, -1.6]],
                                                  np.float32))[0]
            lines.append(f"Car 0.00 0 0.0 400.0 150.0 520.0 230.0 1.5 1.7 "
                         f"4.2 {bottom[0]:.3f} {bottom[1]:.3f} "
                         f"{bottom[2]:.3f} {rng.uniform(-3, 3):.3f}")
        (root / "training" / "label_2" / f"{fid}.txt").write_text(
            "\n".join(lines) + "\n")
        kb = np.zeros((KITTI_DETS, 4), np.float32)
        kb[:, 0] = rng.uniform(0, 1100, KITTI_DETS)
        kb[:, 1] = rng.uniform(80, 280, KITTI_DETS)
        kb[:, 2] = kb[:, 0] + rng.uniform(30, 140, KITTI_DETS)
        kb[:, 3] = kb[:, 1] + rng.uniform(30, 90, KITTI_DETS)
        preds.append(str(root / f"dets_{fid}.json"))
        kb[:, 2:] -= kb[:, :2]          # the CLI reads xywh boxes
        write_coco(preds[-1], f"{fid}.png", kcfg.CLASS_NAMES, kb,
                   rng.randint(1, len(kcfg.CLASS_NAMES) + 1, KITTI_DETS),
                   rng.uniform(0.2, 1.0, KITTI_DETS))
    create_kitti_infos(root, splits=("train",))
    kcfg.DATA_CONFIG.DATA_PATH = str(root)
    kcfg.MODEL.DENSE_HEAD.PREDS_PATHS = preds
    yaml_path = root / "kitti_seeker.yaml"
    yaml_path.write_text(json.dumps(kcfg))
    stores, ms = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        if ex.main(["--cfg_file", str(yaml_path), "--save_path",
                    str(root / f"store_{dev}"), "--device", dev]) != 0:
            raise AssertionError(f"kitti extraction CLI ({dev}) failed")
        ms[dev] = (time.perf_counter() - t0) * 1e3
        stores[dev] = PseudoLabelStore(root / f"store_{dev}")
    err, n = 0.0, 0
    for fid in ids:
        (gb, gs, gl), (cb, cs, cl) = (stores[d].load(fid)
                                      for d in ("cuda", "cpu"))
        if len(gb) != len(cb) or not np.array_equal(gl, cl):
            raise AssertionError(f"kitti CLI frame {fid}: card {len(gb)} "
                                 f"proposals {gl}, CPU {len(cb)} {cl}")
        if len(gb):
            err = max(err, float(np.abs(gb - cb).max()))
            if not (np.abs(gb - cb).max() <= SEEKER_BOX_ATOL and
                    np.abs(gs - cs).max() <= SEEKER_ORACLE_ATOL):
                raise AssertionError(f"kitti CLI frame {fid}: boxes or "
                                     "scores differ from the CPU's")
        n += len(gb)
    if n == 0:
        raise AssertionError("kitti CLI: no proposal stored")
    return {"frames": len(ids), "proposals": n, "max_box_err": err,
            "cli_ms": ms}


def one_zero_row_products(torch, indexing):
    """The tap products of gather mode with the rows gathered against one
    shared zero row, by indexing (`indexing`) or by F.embedding with that
    row as padding_idx: the two gathers that sparse_ops._tap_products
    does not use, timed against it by paper_step_pair."""
    import torch.nn.functional as F

    def products(features, slot, weights):
        b, v, cin = features.shape
        k, _, cout = weights.shape
        n = b * v
        table = torch.cat([features.float().reshape(n, cin),
                           features.new_zeros(1, cin, dtype=torch.float32)])
        base = torch.arange(b, device=slot.device)[:, None, None] * v
        idx = torch.where(slot < v, slot + base, torch.full_like(slot, n))
        rows = table[idx] if indexing else F.embedding(idx, table,
                                                       padding_idx=n)
        return rows.reshape(b, slot.shape[1], k * cin) @ weights.float(
        ).reshape(k * cin, cout)
    return products


# the gathers of gather mode on the yaml's own levels, besides posgather:
# name -> the tap products swapped into sparse_ops (None: its own), the
# warm-up runs and the timed ones (the rejected gathers take seconds and
# run after gather mode has warmed the same shapes)
PAIR_MODES = {"gather": (None, 1, 3), "posgather": (None, 1, 3),
              "gather, indexing one zero row": (True, 0, 1),
              "gather, F.embedding padding row": (False, 0, 1)}


def paper_step_pair(torch, tp, ws, cfg_mod, models_mod, weights, root):
    """Gather mode against posgather mode on the ST yaml's own levels
    (DENSE_FROM_LEVEL 2, its capacities; the main path's windows), and
    gather mode with the two gathers sparse_ops does not use (one shared
    zero row: by indexing, by F.embedding's padding_idx): one batch of 4
    of the tree's frames without augmentation, a training forward and
    backward in each mode from the same weights: median ms of the timed
    runs (CUDA events), peak memory, the K1-K4 launches, both overflows and
    the loss (the same in every gather)."""
    from findnpropagate_torch.datasets.nuscenes import NuScenesDataset
    from findnpropagate_torch.openvocab.self_training import to_device
    from findnpropagate_torch.ops import sparse_ops

    cfg = cfg_mod.cfg_from_yaml_file(str(ROOT / ST_CFG))
    cfg.DATA_CONFIG.update(DATA_PATH=str(root), DATA_AUGMENTOR=None)
    ds = NuScenesDataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, training=True,
                         rng=np.random.RandomState(0))
    batch = to_device(ds.collate_batch(
        [ds[i % len(ds)] for i in range(ST_BATCH)]), "cuda")
    win = cfg_mod.cfg_from_yaml_file(str(ROOT / CFG_FILE)).MODEL.BACKBONE_3D
    own = sparse_ops._tap_products
    out = {}
    for mode, (indexing, warm, reps) in PAIR_MODES.items():
        m = copy.deepcopy(cfg.MODEL)
        if mode == "posgather":
            m.BACKBONE_3D.update({k: win[k] for k in (
                "SUBM_MODE", "SUBM_IMPL", "WINDOWED_BLOCK", "WINDOWED_WINDOW",
                "WINDOWED_STRIDED_WINDOW")})
        if indexing is not None:
            sparse_ops._tap_products = one_zero_row_products(torch, indexing)
        try:
            det = models_mod.build_network(m, len(cfg.CLASS_NAMES), ds)
            weights.init_random_(det, seed=0)
            det.train()
            times = []
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            for rep in range(warm + reps):
                tp.reset_launches()
                ws.reset_launches()
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                loss, tb = det.loss(dict(batch))
                loss.backward()
                t1.record()
                torch.cuda.synchronize()
                det.zero_grad(set_to_none=True)
                if rep >= warm:
                    times.append(t0.elapsed_time(t1))
        finally:
            sparse_ops._tap_products = own
        out[mode] = {"ms": sorted(times)[len(times) // 2], "all_ms": times,
                     "peak_gb": (torch.cuda.max_memory_allocated() - base)
                     / 2 ** 30, "launches": launches_now(tp, ws),
                     "overflow": int(tb["sparse_window_overflow"]),
                     "loss": float(loss.detach())}
        del det, loss, tb
        torch.cuda.empty_cache()
    return out


def paper_phase(torch, tp, ws, smi, cfg_mod, synth, models_mod, weights,
                posgather_ms, profile=None):
    """Self-training through train_st.main on the ST yaml as written (its
    NuScenesDataset and gather backbone; DATA_PATH, scenes, epochs and
    st_warmup set), its gates, the known / unknown evaluation of the
    extracted labels, the narrow gather-mode model against the CPU, and
    the extraction CLI's KITTI mode through KittiDataset."""
    from findnpropagate_torch.datasets.nuscenes import NuScenesDataset
    from findnpropagate_torch.models.dense_heads.transfusion_head import (
        TransFusionHead,
    )
    from findnpropagate_torch.openvocab import self_training
    from findnpropagate_torch.openvocab.pseudo_labels import PseudoLabelStore
    from findnpropagate_torch.runtime import trainer
    from findnpropagate_torch.tools import train_st

    work = ROOT / PAPER_WORK
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t_phase = t0 = time.perf_counter()
    root, infos, tables, seeded = paper_inputs(cfg_mod, synth, work)
    inputs_s = time.perf_counter() - t0
    # with `profile`, the second iteration of epoch 1 (3 steps an epoch)
    # under the profiler, its table in <profile>.st.txt
    probe = STProbe(torch, tp, ws, profile and Path(profile).resolve(),
                    profile_step=4)
    # the CLI runs in `work` (it writes output/ under the working dir); the
    # yaml's _BASE_CONFIG_ path is relative to the repository's root
    (work / "tools").symlink_to(ROOT / "tools")
    cwd = Path.cwd()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        os.chdir(work)
        with Swap(trainer, "make_train_step",
                  probe.make_train_step(trainer.make_train_step)), \
                Swap(trainer, "make_eval_step",
                     probe.make_eval_step(trainer.make_eval_step)), \
                Swap(self_training, "extract_pseudo_labels",
                     probe.extract(self_training.extract_pseudo_labels)), \
                Swap(self_training, "register_pseudo_hooks",
                     probe.hooks(self_training.register_pseudo_hooks)), \
                Swap(TransFusionHead, "get_targets",
                     probe.targets(TransFusionHead.get_targets)), \
                Swap(NuScenesDataset, "__getitem__",
                     probe.getitem(NuScenesDataset.__getitem__)):
            rc = train_st.main([
                "--cfg_file", str(ROOT / ST_CFG), "--epochs",
                str(ST_EPOCHS), "--st_warmup", "1", "--st_interval", "1",
                "--seed", "0", "--pseudo_path", str(work / "frustum"),
                "--st_path", str(work / "st_labels"),
                "--set", "DATA_CONFIG.DATA_PATH", str(root)])
    finally:
        os.chdir(cwd)
    run_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    steps = probe.steps
    # ---- gates
    bb = probe.detector.backbone_3d
    if rc != 0 or not steps or len(steps) % ST_EPOCHS:
        raise AssertionError(f"paper: rc {rc}, {len(steps)} steps")
    if not isinstance(probe.train_ds, NuScenesDataset) or bb.windowed:
        raise AssertionError(f"paper: dataset {type(probe.train_ds)}, "
                             f"backbone windowed={bb.windowed}")
    for i, s in enumerate(steps):
        if s["launches"] != GATHER_LAUNCHES:
            raise AssertionError(f"paper step {i}: launches {s['launches']}")
        if not (math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])
                and s["grad_norm"] > 0 and s["overflow"] == 0):
            raise AssertionError(f"paper step {i}: {s}")
    changed = sum(bool((p.detach() != q).any()) for p, q in zip(
        probe.detector.parameters(), probe.params))
    if changed < 0.9 * len(probe.params):
        raise AssertionError(f"paper: only {changed} of "
                             f"{len(probe.params)} parameters changed")
    ext, = probe.extractions
    st = PseudoLabelStore(work / "st_labels")
    train_infos = pickle.loads(infos["train"].read_bytes())
    fids = [Path(i["lidar_path"]).stem for i in train_infos]
    labels = [st.load(f) for f in fids]
    n_boxes = [len(b) for b, _, _ in labels]
    if st.stamped_epoch() != 1 or not all(n_boxes):
        raise AssertionError(f"paper: self-train store stamped "
                             f"{st.stamped_epoch()}, boxes {n_boxes}")
    # ---- the known / unknown evaluation of the extracted labels over the
    # train frames (the extraction's split)
    cfg = cfg_mod.cfg_from_yaml_file(str(ROOT / ST_CFG))
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    full = list(cfg.FULL_CLASS_NAMES)
    eval_ds = NuScenesDataset(cfg.DATA_CONFIG, full, training=False)
    eval_ds.infos = train_infos
    dets = [{"boxes": b, "scores": sc, "labels": lb} for b, sc, lb in labels]
    t0 = time.perf_counter()
    _, res = eval_ds.evaluation(dets, full,
                                known_classes=list(cfg.KNOWN_CLASS_NAMES))
    eval_ms = (time.perf_counter() - t0) * 1e3
    if not all(math.isfinite(res[k]) for k in ("AP_B", "AP_N", "AR_N",
                                               "NDS", "mAP")):
        raise AssertionError(f"paper: evaluation {res}")
    # ---- the narrow gather-mode model, card against CPU
    with tf32_off(torch):
        ref = reference_phase(
            torch, cfg_mod, synth, models_mod, weights,
            backbone=cfg_mod.cfg_from_yaml_file(
                str(ROOT / ST_CFG)).MODEL.BACKBONE_3D,
            rtol=GATHER_REF_RTOL)
    ref_tf32 = reference_phase(
        torch, cfg_mod, synth, models_mod, weights,
        backbone=cfg_mod.cfg_from_yaml_file(
            str(ROOT / ST_CFG)).MODEL.BACKBONE_3D,
        rtol=GATHER_REF_TF32_RTOL)
    kitti = paper_kitti_check(torch, cfg_mod, work)
    pair = paper_step_pair(torch, tp, ws, cfg_mod, models_mod, weights, root)
    gathers = [v for k, v in pair.items() if k != "posgather"]
    if any(v["launches"] != GATHER_LAUNCHES or v["overflow"]
           or not abs(v["loss"] - pair["gather"]["loss"])
           <= GATHER_LOSS_RTOL * abs(pair["gather"]["loss"])
           for v in gathers) or not all(
            math.isfinite(v["loss"]) for v in pair.values()):
        raise AssertionError(f"paper: gather / posgather steps {pair}")

    n_epoch = len(steps) // ST_EPOCHS
    e1 = steps[n_epoch:]
    med = sorted(s["ms"] for s in e1)[len(e1) // 2]
    out = {
        "device": smi, "inputs_s": inputs_s, "run_s": run_s,
        "tables": tables, "train_infos": len(train_infos),
        "steps_per_epoch": n_epoch, "seeded_per_frame": seeded,
        "ms_per_step_epoch1": med, "posgather_ms_per_step_epoch1":
        posgather_ms, "steps": steps,
        "iter_ms": [s["iter_ms"] for s in steps],
        "wait_ms": [s["wait_ms"] for s in steps],
        "loader_host_ms_per_batch": probe.sample_s * 1e3 / len(steps),
        "extraction_ms_per_frame": ext["ms_per_frame"],
        "selftrain_boxes_per_frame": n_boxes, "peak_mem_gb": peak,
        "eval_ms": eval_ms, "eval": {k: res[k] for k in (
            "mAP", "NDS", "AP_B", "AP_N", "AR_N", "mATE", "mASE", "mAOE",
            "mAVE", "mAAE")},
        "reference_rel_err": ref, "reference_rel_err_tf32": ref_tf32,
        "kitti": kitti, "busy": probe.busy,
        "same_levels": pair,
        "phase_s": time.perf_counter() - t_phase}
    log(f"paper yaml ({smi}): {ST_CFG} as written (NuScenesDataset, gather "
        f"backbone), {len(train_infos)} train infos after CBGS, "
        f"{n_epoch} steps per epoch; inputs {inputs_s:.1f} s, "
        f"train_st.main {run_s:.1f} s; gather mode {med:.1f} ms per "
        f"self-training step (median of epoch 1, CUDA events) against "
        f"posgather mode's {posgather_ms:.1f} (phase 10, this run); steps "
        f"{[round(s['ms'], 1) for s in steps]} ms, wall per iteration "
        f"{[None if t is None else round(t, 1) for t in out['iter_ms']]} ms "
        f"(waits {[None if t is None else round(t, 1) for t in out['wait_ms']]}"
        f"), loader host {out['loader_host_ms_per_batch']:.1f} ms per batch, "
        f"extraction {ext['ms_per_frame']:.1f} ms/frame, peak {peak:.2f} GiB")
    log(f"paper yaml ({smi}): losses {[round(s['loss'], 3) for s in steps]}"
        f", self-train boxes per frame {n_boxes}, evaluation of the "
        f"extracted labels ({eval_ms:.1f} ms host): "
        + ", ".join(f"{k} {v:.4f}" for k, v in out["eval"].items())
        + f"; narrow gather model card vs CPU {ref} (cuDNN TF32 off), "
        f"{ref_tf32} (default flags); KITTI CLI "
        f"{kitti['proposals']} proposals on {kitti['frames']} frames, card "
        f"= CPU (max box err {kitti['max_box_err']:.3g}; CLI ms "
        f"{ {k: round(v) for k, v in kitti['cli_ms'].items()} }); phase "
        f"{out['phase_s']:.1f} s")
    log(f"paper yaml ({smi}): peak GiB after each step "
        f"{[round(s['peak_gb'], 2) for s in steps]}")
    log(f"paper yaml ({smi}): on the yaml's own levels (DENSE_FROM_LEVEL 2),"
        " one batch, training forward + backward (median of the timed "
        "repetitions after a warm-up, CUDA events):"
        + "; ".join(f" {k} {v['ms']:.1f} ms {v['all_ms']}, peak "
                    f"{v['peak_gb']:.2f} GiB, overflow {v['overflow']}, "
                    f"loss {v['loss']!r}, launches {v['launches']}"
                    for k, v in pair.items()))
    if probe.busy:
        log(f"paper yaml profile ({smi}): one epoch-1 iteration wall "
            f"{probe.busy['wall_ms']:.1f} ms, kernels "
            f"{probe.busy['kernel_ms']:.1f} ms, busy "
            f"{probe.busy['busy_share']:.3f}")
    return out


# ------------------------------------------------------------- CenterPoint


CP_CFGS = {
    "voxel0075": "tools/cfgs/nuscenes_models/"
                 "cbgs_voxel0075_res3d_centerpoint.yaml",
    "voxel01": "tools/cfgs/nuscenes_models/"
               "cbgs_voxel01_res3d_centerpoint.yaml",
}
# per eval forward and per training step: the 0075 yaml's SUBM_IMPL pallas
# runs every sparse conv through K3 (16 forward, 15 transposed: the input
# conv needs no input gradient) and K4, as phase 5's pallas-mode step and
# phase 7's forward; the 01 yaml's posgather runs the main path's K1 / K2
# forward and phase 5's training launches
CP_EVAL_LAUNCHES = {"voxel0075": {"positions": 0, "posgather_conv": 0,
                                  "windowed_conv": 16, "windowed_dw": 0},
                    "voxel01": EVAL_LAUNCHES}
CP_TRAIN_LAUNCHES = {"voxel0075": PALLAS_TRAIN_LAUNCHES,
                     "voxel01": TRAIN_LAUNCHES}
# VoxelBackBone8x on the 0075 yaml: 10 sparse convs (the input conv, two
# submanifold convs a stage at L0-L2, the strided convs into L1-L3)
PLAIN_EVAL_LAUNCHES = {"positions": 0, "posgather_conv": 0,
                       "windowed_conv": 10, "windowed_dw": 0}
PLAIN_TRAIN_LAUNCHES = {"positions": 0, "posgather_conv": 0,
                        "windowed_conv": 19, "windowed_dw": 10}
# bench.py's scenes need wider L0 windows than the CenterPoint yamls give
# (sized by hand for the reference's TPU kernel): as written, their L0 ->
# L1 strided conv (window 2048) and L0 submanifold convs (2048) drop
# neighbour spans (a batch-4 forward: 42 in the 0075 yaml, 35 in the 01
# yaml on an NVIDIA H100 80GB HBM3 at 700 W). The gated runs take the main
# path's L0 windows (CFG_FILE's, sized for these scenes); the yaml as
# written runs one batch-4 forward whose overflow is printed.
CP_WIDEN = ("WINDOWED_WINDOW", "WINDOWED_STRIDED_WINDOW")
CP_BATCHES = (1, 4)
CP_TRAIN_STEPS = 3           # timed, after a warm-up step
# the narrow model, card against CPU: in gather mode float32 on both sides
# (cuDNN's TF32 off), sums in another order; in the yaml's pallas mode K3
# rounds its operands to bf16 on the card, the CPU's plain version does
# not (phase 4's bound)
CP_REF_RTOL = 1e-4
CP_REF_BF16_RTOL = 3e-2
CP_BOX_ATOL = 1e-4
# decoded boxes may differ where two candidate scores lie this close: the
# top-k and NMS order of near-equal scores follows each side's rounding
CP_TIE = 1e-5
CP_CLI_EPOCHS = 2
CP_CLI_TIMEOUT = 900
CP_WORK = "build/centerpoint"
# the evaluation of the self-trained checkpoint covers the full class list
# (FULL_CLASS_NAMES), so that its unknown classes are scored
ST_FULL_NAMES = ("car,truck,construction_vehicle,bus,trailer,barrier,"
                 "motorcycle,bicycle,pedestrian,traffic_cone")


def cp_voxel(cfg):
    return list(next(p["VOXEL_SIZE"] for p in cfg.DATA_CONFIG.DATA_PROCESSOR
                     if p["NAME"] == "transform_points_to_voxels"))


def cp_dataset(cfg_mod, synth, cfg, n, training, **kw):
    """bench.py's 200k-point lidar_ring scenes in the yaml's range and
    voxel size."""
    kw.setdefault("voxel", cp_voxel(cfg))
    return synth.SyntheticDataset(cfg_mod.EDict(synth.bench_data_cfg(
        n, cfg, **kw)), cfg.CLASS_NAMES, training=training)


def cp_widen(cfg_mod, cfg, levels=1, factor=1):
    """The yaml's windows of the first `levels` levels widened to `factor`
    times the main path's (CP_WIDEN; L0 alone by default); returns {key:
    (as written, now)}."""
    main = cfg_mod.cfg_from_yaml_file(str(ROOT / CFG_FILE)).MODEL.BACKBONE_3D
    bb, changed = cfg.MODEL.BACKBONE_3D, {}
    per_level = lambda v: list(v) if isinstance(  # noqa: E731
        v, (list, tuple)) else [v] * 3
    for key in CP_WIDEN:
        old = per_level(bb[key])
        bb[key] = [max(a, factor * b) for a, b in zip(
            old[:levels], per_level(main[key]))] + old[levels:]
        changed[key] = (old, list(bb[key]))
    return changed


@contextlib.contextmanager
def overflow_sites(torch, ws, shapes=()):
    """Every window check of the backbone's sparse convs run inside, in
    call order: [kind, window, targets, the counter's blocks, the blocks
    whose real targets overflow] (tensors). The reference's counter for a
    differentiable strided conv checks its transposed direction with the
    sentinel start of the strided base ids, below which the input list's
    own padding lies: a block of real inputs followed by padding then
    counts the padding's span. The last column recounts that direction
    with the input list's own sentinel start (its level among `shapes`)."""
    import importlib

    from findnpropagate_torch.ops import sparse_ops

    bb = importlib.import_module(
        "findnpropagate_torch.models.backbones_3d.spconv_backbone")
    sites = []
    orig = (bb.compute_positions, bb.windowed_conv, bb.windowed_conv_diff)
    own = {sparse_ops.strided_sentinel_start(s):
           sparse_ops.yxz_sentinel_start(s) for s in shapes}

    def positions(src, tgt, deltas, *a, **kw):
        ctx = orig[0](src, tgt, deltas, *a, **kw)
        sites.append(["positions", kw.get("window"), tgt.shape[1],
                      ctx.overflow, ctx.overflow])
        return ctx

    def conv(src, feats, tgt, w, deltas, *a, **kw):
        out, ovf = orig[1](src, feats, tgt, w, deltas, *a, **kw)
        sites.append(["windowed", kw.get("window"), tgt.shape[1], ovf, ovf])
        return out, ovf

    def conv_diff(src, feats, tgt, w, deltas, block=512, window=1536,
                  sentinel_start=None, **kw):
        out, ovf = orig[2](src, feats, tgt, w, deltas, block=block,
                           window=window, sentinel_start=sentinel_start,
                           **kw)
        d = torch.as_tensor(np.asarray(
            deltas.cpu() if isinstance(deltas, torch.Tensor) else deltas,
            np.int64))
        with torch.no_grad():
            exact = ws.windowed_overflow(
                src, tgt, d, block, window, sentinel_start=sentinel_start) \
                + ws.windowed_overflow(
                    tgt, src, -d, block, window,
                    sentinel_start=own.get(sentinel_start, sentinel_start))
        sites.append(["windowed_diff", window, tgt.shape[1], ovf, exact])
        return out, ovf
    bb.compute_positions, bb.windowed_conv, bb.windowed_conv_diff = \
        positions, conv, conv_diff
    try:
        yield sites
    finally:
        bb.compute_positions, bb.windowed_conv, bb.windowed_conv_diff = orig


def dropped(sites):
    """The sites whose counter is not 0: [kind, window, targets, counter,
    real]."""
    return [[k, w, vt, int(o.sum()), int(e.sum())]
            for k, w, vt, o, e in sites if int(o.sum())]


def cp_launch_gate(label, got, want):
    """`got` must equal `want` (any counts where `want` is None)."""
    if want is not None and got != want:
        raise AssertionError(f"{label}: launches {got}, want {want}")


def cp_forward(torch, det, batch, tp, ws, want, label):
    """One eval forward + post_process with the launch counts set to 0
    just before and read just after; its gates."""
    tp.reset_launches()
    ws.reset_launches()
    out = det(batch)
    dets = det.post_process(out)
    torch.cuda.synchronize()
    launches = launches_now(tp, ws)
    cp_launch_gate(label, launches, want)
    # a detector without a sparse backbone has no overflow to report
    if int(out.get("sparse_window_overflow", 0)) != 0:
        raise AssertionError(f"{label}: sparse_window_overflow "
                             f"{int(out['sparse_window_overflow'])}")
    if not (bool(torch.isfinite(dets.boxes).all())
            and bool(torch.isfinite(dets.scores).all())
            and int(dets.count.min()) > 0):
        raise AssertionError(f"{label}: detections not finite or none "
                             f"(counts {dets.count.tolist()})")
    return out, dets, launches


def cp_step(torch, step, batch, tp, ws, want, label, overflow_ok=0):
    """One optimizer step with the launch counts set to 0 just before and
    read just after; its gates (`overflow_ok`: the overflow counter's
    value the gate accepts, None for any)."""
    tp.reset_launches()
    ws.reset_launches()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    metrics = step(batch)
    t1.record()
    torch.cuda.synchronize()
    launches = launches_now(tp, ws)
    cp_launch_gate(label, launches, want)
    m = {k: float(v) for k, v in metrics.items()}
    if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
            and m["grad_norm"] > 0):
        raise AssertionError(f"{label}: loss {m['loss']} grad_norm "
                             f"{m['grad_norm']}")
    if overflow_ok is not None and m.get("sparse_window_overflow",
                                         0) != overflow_ok:
        raise AssertionError(f"{label}: sparse_window_overflow "
                             f"{m['sparse_window_overflow']}")
    return {"ms": t0.elapsed_time(t1), "launches": launches, **m}


def cp_actives(torch, det, batch, n):
    """Actives per level of each of the first n scenes of `batch` (batch-1
    forwards) beside the capacities the backbone gives its sparse levels:
    L0 MAX_VOXELS, L1 and L2 LEVEL_CAPACITIES[2] and [3] (rounded up to a
    block); the dense levels (from DENSE_FROM_LEVEL on) have no cap."""
    bb = det.backbone_3d
    block = bb._win_cfg()[0]
    caps = [det.max_voxels] + [-(-c // block) * block for c in bb.caps[2:4]]
    dense_from = int(bb.model_cfg.get("DENSE_FROM_LEVEL", 1))
    per_scene = []
    with torch.no_grad():
        for i in range(n):
            out = det({k: v[i:i + 1] for k, v in batch.items()})
            per_scene.append([int(c) for c in out["sparse_active_counts"]])
    caps = [c if lvl < dense_from else None for lvl, c in enumerate(caps)]
    at_cap = [lvl for lvl, c in enumerate(caps) if c is not None and any(
        s[lvl] >= c for s in per_scene)]
    return {"per_scene": per_scene, "caps": caps, "at_cap": at_cap,
            "level_capacities": list(bb.caps)}


def cp_head_profile(torch, det, batch, path):
    """One forward + post_process under the profiler with the head's
    forward and its decode in ranges of their own: the span of each range
    on the device's timeline (its kernels and the gaps between them)
    against the forward's wall time (the head's share of a forward), and
    the summed kernel time."""
    from torch.profiler import ProfilerActivity, profile, record_function

    head = det.dense_head
    fwd, dec = head.forward, head.get_bboxes

    def ranged(name, fn):
        def run(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return run

    head.forward = ranged("cp_head_forward", fwd)
    head.get_bboxes = ranged("cp_head_decode", dec)
    try:
        det.post_process(det(batch))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            det.post_process(det(batch))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        del head.forward, head.get_bboxes
    avg = prof.key_averages()
    names = ("cp_head_forward", "cp_head_decode")
    # the ranges show on the device too, as annotations spanning their
    # kernels: counted as spans, not as kernels
    kernel_ms = sum(e.self_device_time_total for e in avg
                    if e.device_type.name == "CUDA"
                    and e.key not in names) / 1e3
    spans = {e.key: e.self_device_time_total / 1e3 for e in avg
             if e.key in names and e.device_type.name == "CUDA"}
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(avg.table(sort_by="self_cuda_time_total",
                                    row_limit=50))
    return {"wall_ms": wall, "kernel_ms": kernel_ms,
            "busy_share": kernel_ms / wall, "head_span_ms": spans,
            "head_share_of_wall": sum(spans.values()) / wall}


def cp_summary(rows, name, path, launches):
    """One `kernels` entry of a phase-13 run: the kernel's recorded calls
    of that run summed (ms, device ms, plain ms, bound, library), their
    largest error."""
    mine = [r for r in rows if r["name"] == name]
    big = max(mine, key=lambda r: r["bound_ms"])

    def total(key):
        vals = [r.get(key) for r in mine]
        return None if any(v is None for v in vals) else sum(vals)

    return {"name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "path": path, "launches": launches,
            "calls": len(mine),
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": total("ms"), "device_ms": total("device_ms"),
            "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_by": big["bound_by"],
            "library_ms": total("library_ms") if name == "positions"
            else None}


def synthetic_data(cfg_mod, synth):
    """cp_yaml_run's data by default: bench.py's 200k-point lidar_ring
    scenes in the yaml's range and voxel size (cp_dataset)."""
    def data(cfg, training, n):
        t0 = time.perf_counter()
        ds = cp_dataset(cfg_mod, synth, cfg, n, training=training)
        batch = ds.batch(range(n))
        return ds, batch, (time.perf_counter() - t0) * 1e3
    return data


def cp_yaml_run(torch, name, mods, smi, args, device="cuda", yaml=None,
                data=None, launches=None, steps=CP_TRAIN_STEPS,
                label="centerpoint", record=True, widen=(1, 1),
                exact_gate=False):
    """One yaml as written at full width: a forward of the yaml as written
    (its overflow and actives per level), then with the widened L0 windows
    forwards at batch 1 and 4 and training steps at its batch of 4 with its
    own optimizer; with `record`, the launches and arguments of one batch-4
    forward and one step recorded and every recorded call held against its
    plain version. `yaml`: CP_CFGS[name] by default; `data(cfg, training,
    n)` -> (dataset, batch of n samples as numpy, the host ms that batch
    took), bench.py's scenes by default; `launches`:
    (per forward, per step), CP_EVAL_LAUNCHES / CP_TRAIN_LAUNCHES of `name`
    by default; `widen`: cp_widen's levels and factor for the gated runs;
    `exact_gate`: training steps gated on the blocks whose real targets
    overflow (overflow_sites), not on the counter. Returns (report, rows,
    kernels entries)."""
    cfg_mod, models_mod, synth, tp, ws, lap, weights, optimization, \
        trainer = mods
    yaml = yaml or CP_CFGS[name]
    cfg = cfg_mod.cfg_from_yaml_file(str(ROOT / yaml))
    data = data or synthetic_data(cfg_mod, synth)
    want_eval, want_train = launches or (CP_EVAL_LAUNCHES[name],
                                         CP_TRAIN_LAUNCHES[name])
    n_class = len(cfg.CLASS_NAMES)
    dev = torch.device(device)
    b_max = max(CP_BATCHES)
    ds, batch, host_ms = data(cfg, False, b_max)
    batches = {b: {k: torch.from_numpy(v[:b]).to(dev)
                   for k, v in batch.items()} for b in CP_BATCHES}
    rep = {"yaml": yaml, "device": smi, "forward": {},
           "loader_ms_eval_batch": host_ms,
           "points_per_scan": [int(v) for v in batch["points_mask"].sum(1)]}
    # the yaml as written: one batch-4 forward, its overflow and actives
    det = models_mod.build_network(copy.deepcopy(cfg.MODEL), n_class, ds,
                                   device=dev)
    weights.init_random_(det, seed=0)
    with torch.no_grad(), overflow_sites(torch, ws) as sites:
        out = det(batches[b_max])
        dets = det.post_process(out)
    if not bool(torch.isfinite(dets.boxes).all()):
        raise AssertionError(f"{name} as written: non-finite boxes")
    rep["as_written"] = {"overflow": int(out["sparse_window_overflow"]),
                         "dropped_at": dropped(sites),
                         "windows": cp_widen(cfg_mod, cfg, *widen)}
    rep["actives"] = cp_actives(torch, det, batches[b_max], b_max)
    del det, out, dets
    det = models_mod.build_network(copy.deepcopy(cfg.MODEL), n_class, ds,
                                   device=dev)
    weights.init_random_(det, seed=0)
    for b in CP_BATCHES:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _, dets, got = cp_forward(torch, det, batches[b], tp, ws, want_eval,
                                  f"{label} {name} forward batch {b}")
        med, times = forward_ms(torch, det, batches[b], args.reps)
        rep["forward"][b] = {
            "launches": got, "ms_per_batch": med,
            "ms_per_scan": med / b, "times_ms": times,
            "detections_per_scan": [int(c) for c in dets.count],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    if record:
        with record_positions(torch, tp) as k1_eval, \
                Recorder(tp, "gather_conv", torch) as k2_eval, \
                Recorder(ws, "conv_kernel", torch) as k3_eval:
            cp_forward(torch, det, batches[b_max], tp, ws, want_eval,
                       f"{label} {name} recorded forward")
    if args.profile:
        rep["profile"] = cp_head_profile(
            torch, det, batches[b_max], f"{args.profile}.cp_{name}.txt")
    del det, batches
    torch.cuda.empty_cache()

    # ---- training at the yaml's batch, its adam_onecycle and clip
    tds, tbatch, rep["loader_ms_train_batch"] = data(
        cfg, True, int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU))
    det = models_mod.build_network(copy.deepcopy(cfg.MODEL), n_class, tds,
                                   device=dev)
    weights.init_random_(det, seed=0)
    det.train()
    batch = {k: torch.from_numpy(v).to(dev) for k, v in tbatch.items()}
    tx, _ = optimization.build_optimizer(det.parameters(), cfg.OPTIMIZATION,
                                         1000)
    step = trainer.make_train_step(det, tx)
    params = [p.detach().clone() for p in det.parameters()]
    with overflow_sites(torch, ws, det.backbone_3d.level_shapes) as sites:
        warm = cp_step(torch, step, batch, tp, ws, want_train,
                       f"{label} {name} train warm-up", overflow_ok=None)
    # the gate counts the blocks whose real targets overflow; the counter
    # (the reference's) must then read the same on every step of the batch
    real = sum(e for *_, e in dropped(sites))
    counter = warm["sparse_window_overflow"]
    if real or (counter and not exact_gate):
        raise AssertionError(
            f"{label} {name} train warm-up: sparse_window_overflow "
            f"{counter}; [kind, window, targets, counter, real] "
            f"{dropped(sites)}")
    warm["dropped_at"] = dropped(sites)
    changed = sum(bool((p.detach() != q).any())
                  for p, q in zip(det.parameters(), params))
    if changed < 0.9 * len(params):
        raise AssertionError(f"{name} train: only {changed} of "
                             f"{len(params)} parameter tensors changed")
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    timed = [cp_step(torch, step, batch, tp, ws, want_train,
                     f"{label} {name} train step", counter)
             for _ in range(steps)]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if record:
        with record_positions(torch, tp) as k1_train, \
                Recorder(tp, "gather_conv", torch) as k2_train, \
                Recorder(ws, "conv_kernel", torch) as k3_train, \
                Recorder(ws, "dw_kernel", torch) as k4_train:
            cp_step(torch, step, batch, tp, ws, want_train,
                    f"{label} {name} recorded step", counter)
    rep["train"] = {
        "batch": len(batch["points"]), "warm_up": warm, "steps": timed,
        "ms_per_step": sorted(s["ms"] for s in timed)[len(timed) // 2],
        "losses": [warm["loss"]] + [s["loss"] for s in timed],
        "peak_mem_gb": peak, "parameters_changed": changed}
    del det, tx, step, batch
    torch.cuda.empty_cache()
    if not record:
        return rep, [], []

    # ---- every recorded call against its plain version
    fwd_rows = check_positions(torch, tp, k1_eval, f"{name} forward ")
    fwd_rows += check_kernels(torch, tp, [], k2_eval.calls)
    fwd_rows += check_windowed_conv(torch, ws, k3_eval.calls,
                                    lambda i: "eval epilogue",
                                    f"{name} forward ")
    train_rows = check_positions(torch, tp, k1_train, f"{name} train ")
    train_rows += check_train_kernels(
        torch, tp, ws, k2_train.calls, k3_train.calls, k4_train.calls,
        k3_forward=want_eval["windowed_conv"]
        or want_train["windowed_conv"] // 2)
    log_positions_rows([r for r in fwd_rows + train_rows
                        if r["name"] == "positions"], f"{name} ")
    log_conv_rows([r for r in fwd_rows + train_rows
                   if r["name"] != "positions"])
    entries = []
    for rows, path, got in (
            (fwd_rows, f"{label} {name} forward batch {b_max}",
             rep["forward"][b_max]["launches"]),
            (train_rows, f"{label} {name} training step batch "
             f"{rep['train']['batch']}", rep["train"]["steps"][0]["launches"])):
        for kname in SOURCES:
            if got.get(kname):
                entries.append(cp_summary(rows, kname, path, got[kname]))
    return rep, fwd_rows + train_rows, entries


def cp_candidate_margins(torch, preds_all, k):
    """Per sample, the sorted top-k scores of every group: the candidates
    that the decode ranks and NMS orders."""
    from findnpropagate_torch.models.model_utils.centernet import (
        topk_heatmap,
    )

    tops = [topk_heatmap(torch.sigmoid(p["hm"].permute(0, 3, 1, 2)), k)[0]
            for p in preds_all]
    return torch.sort(torch.cat(tops, dim=1), dim=1).values


def cp_hold_decode(torch, card, cpu, cand, label):
    """Detections of the card against the CPU's: each detection of either
    side has one on the other with the same label and a box within
    CP_BOX_ATOL, unless its score lies within CP_TIE of another candidate
    score (printed with its margin). Returns (max box error of the matched,
    the exempted)."""
    worst, exempt = 0.0, []
    for side, a, b in (("card", card, cpu), ("cpu", cpu, card)):
        for i in range(a.boxes.shape[0]):
            nb = int(b.count[i])
            scores = cand[i]
            for j in range(int(a.count[i])):
                box, lbl = a.boxes[i, j], int(a.labels[i, j])
                err = (b.boxes[i, :nb] - box).abs().amax(dim=-1)
                err = torch.where(b.labels[i, :nb] == lbl, err,
                                  torch.full_like(err, float("inf")))
                if nb and float(err.min()) <= CP_BOX_ATOL:
                    worst = max(worst, float(err.min()))
                    continue
                s = float(a.scores[i, j])
                gaps = (scores - s).abs()
                margin = float(torch.sort(gaps).values[1]) \
                    if len(gaps) > 1 else float("inf")
                if margin > CP_TIE:
                    raise AssertionError(
                        f"{label}: {side} detection {j} of sample {i} "
                        f"(label {lbl}, score {s}) has no match and its "
                        f"nearest candidate score is {margin} away")
                exempt.append({"side": side, "sample": i, "slot": j,
                               "label": lbl, "score": s, "margin": margin})
    for e in exempt:
        log(f"{label}: near tie, {e}")
    return worst, exempt


def cp_reference(torch, cfg_mod, synth, models_mod, weights, card="cuda"):
    """A narrow CenterPoint (the 0075 yaml at 16 channels, +-6.4 m, as
    phase 4 narrows TransFusion) on the card and on the CPU: in gather mode
    (float32 on both sides, cuDNN's TF32 off) the actives equal, every
    group's heatmap and regression within CP_REF_RTOL, the decoded boxes
    and labels equal (cp_hold_decode); in the yaml's pallas mode the
    actives equal and the maps within CP_REF_BF16_RTOL."""
    cfg = cfg_mod.cfg_from_yaml_file(str(ROOT / CP_CFGS["voxel0075"]))
    m = cfg.MODEL
    m.BACKBONE_3D.update({
        "MAX_VOXELS": 2048, "LEVEL_CAPACITIES": [2048, 2048, 2048, 1024,
                                                 1024],
        "WINDOWED_BLOCK": 512, "CHANNELS": [16, 16, 16, 16, 16],
        "OUT_CHANNELS": 16, "DENSE_DTYPE": "f32"})
    m.MAP_TO_BEV.NUM_BEV_FEATURES = 32
    m.BACKBONE_2D.update({"LAYER_NUMS": [1, 1], "NUM_FILTERS": [16, 32],
                          "NUM_UPSAMPLE_FILTERS": [16, 16]})
    m.DENSE_HEAD.SHARED_CONV_CHANNEL = 16
    ds = cp_dataset(cfg_mod, synth, cfg, 2, training=False,
                    pcr=[-6.4, -6.4, -5.0, 6.4, 6.4, 3.0],
                    voxel=[0.2, 0.2, 0.2], max_voxels=2048,
                    max_points=40000)
    batch = ds.batch(range(2))
    k = int(m.DENSE_HEAD.POST_PROCESSING.MAX_OBJ_PER_SAMPLE)
    res = {}
    for mode in ("gather", "pallas"):
        mcfg = copy.deepcopy(m)
        if mode == "gather":
            for key in ("SUBM_MODE", "SUBM_IMPL"):
                mcfg.BACKBONE_3D.pop(key)
        outs, dets = {}, {}
        with tf32_off(torch):
            for dev in (card, "cpu"):
                det = models_mod.build_network(copy.deepcopy(mcfg), 10, ds,
                                               device=dev)
                weights.init_random_(det, seed=1)
                with torch.no_grad():
                    outs[dev] = det({key: torch.from_numpy(v).to(dev)
                                     for key, v in batch.items()})
                    dets[dev] = det.post_process(outs[dev])
        g, c = outs[card], outs["cpu"]
        if not torch.equal(g["sparse_active_counts"].cpu(),
                           c["sparse_active_counts"]):
            raise AssertionError(f"centerpoint reference {mode}: active "
                                 "counts differ")
        if int(g["sparse_window_overflow"]) or int(
                c["sparse_window_overflow"]):
            raise AssertionError(f"centerpoint reference {mode}: overflow")
        rtol = CP_REF_RTOL if mode == "gather" else CP_REF_BF16_RTOL
        pairs = {"encoded_spconv_tensor": (g["encoded_spconv_tensor"],
                                           c["encoded_spconv_tensor"])}
        for gi, (pg, pc) in enumerate(zip(g["center_preds"],
                                          c["center_preds"])):
            pairs.update({f"group{gi}/{key}": (pg[key], pc[key])
                          for key in pc})
        errs = {}
        for key, (a, b) in pairs.items():
            rel = float((a.cpu() - b).norm() / b.norm().clamp_min(1e-12))
            errs[key] = rel
            if not rel <= rtol:
                raise AssertionError(f"centerpoint reference {mode}: {key} "
                                     f"rel err {rel}")
        out = {"spconv_rel_err": errs["encoded_spconv_tensor"],
               "worst_map_rel_err": max(v for k, v in errs.items()
                                        if k.startswith("group")),
               "maps": errs,
               "actives": [int(v) for v in c["sparse_active_counts"]]}
        if mode == "gather":
            got = type(dets["cpu"])(*(t.cpu() for t in dets[card]))
            cand = cp_candidate_margins(torch, c["center_preds"], k)
            out["max_box_err"], out["near_ties"] = cp_hold_decode(
                torch, got, dets["cpu"], cand, "centerpoint reference")
            out["detections"] = [int(n) for n in dets["cpu"].count]
        res[mode] = out
    return res


def cp_variants(torch, mods, smi, device="cuda"):
    """CenterHeadCLIP (512-wide embeddings) and VoxelBackBone8x in place of
    the 0075 yaml's head and backbone, set from code, at full width: the
    CLIP head's batch-1 loss (training forward) and decode, the plain
    backbone's batch-1 forward and one training step."""
    cfg_mod, models_mod, synth, tp, ws, lap, weights, optimization, \
        trainer = mods
    dev = torch.device(device)
    out = {}
    for variant in ("CenterHeadCLIP", "VoxelBackBone8x"):
        cfg = cfg_mod.cfg_from_yaml_file(str(ROOT / CP_CFGS["voxel0075"]))
        cp_widen(cfg_mod, cfg)
        if variant == "CenterHeadCLIP":
            cfg.MODEL.DENSE_HEAD.NAME = variant
        else:
            cfg.MODEL.BACKBONE_3D.NAME = variant
        ds = cp_dataset(cfg_mod, synth, cfg, 2, training=True)
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in ds.batch(range(1)).items()}
        det = models_mod.build_network(copy.deepcopy(cfg.MODEL), 10, ds,
                                       device=dev)
        weights.init_random_(det, seed=0)
        rep = {}
        if variant == "CenterHeadCLIP":
            det.train()
            tp.reset_launches()
            ws.reset_launches()
            loss, tb = det.loss(batch)
            torch.cuda.synchronize()
            rep["train_forward_launches"] = launches_now(tp, ws)
            rep["loss"] = {k: float(v) for k, v in tb.items()}
            if not (math.isfinite(float(loss.detach()))
                    and rep["loss"]["emb_loss"] > 0
                    and rep["loss"]["sparse_window_overflow"] == 0):
                raise AssertionError(f"CenterHeadCLIP: loss {rep['loss']}")
            det.eval()
            with torch.no_grad():
                _, dets, rep["eval_launches"] = cp_forward(
                    torch, det, batch, tp, ws,
                    CP_EVAL_LAUNCHES["voxel0075"], "CenterHeadCLIP forward")
            rep["detections"] = int(dets.count[0])
            rep["embed_dim"] = int(det.dense_head.embed_dim)
        else:
            det.eval()
            with torch.no_grad():
                _, dets, rep["eval_launches"] = cp_forward(
                    torch, det, batch, tp, ws, PLAIN_EVAL_LAUNCHES,
                    "VoxelBackBone8x forward")
            det.train()
            tx, _ = optimization.build_optimizer(det.parameters(),
                                                 cfg.OPTIMIZATION, 1000)
            rep["step"] = cp_step(torch, trainer.make_train_step(det, tx),
                                  batch, tp, ws, PLAIN_TRAIN_LAUNCHES,
                                  "VoxelBackBone8x train step")
            del tx
        out[variant] = rep
        log(f"centerpoint variant {variant} ({smi}), 0075 yaml, batch 1: "
            f"{rep}")
        del det, batch
        torch.cuda.empty_cache()
    return out


def run_cli(module, argv, cwd, label):
    """`python -m findnpropagate_torch.tools.<module> argv` in `cwd` with
    this checkout on the path: its wall seconds and output; raises unless
    it exits 0."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"findnpropagate_torch.tools.{module}",
         *argv], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=CP_CLI_TIMEOUT)
    wall = time.perf_counter() - t0
    (Path(cwd) / f"{label}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tail = (proc.stdout + proc.stderr)[-3000:]
        raise AssertionError(f"{label}: exit {proc.returncode}\n{tail}")
    return wall, proc.stdout + proc.stderr


def cp_cli_phase(torch, smi, paper_root):
    """The port's train.py on the 0075 yaml (only DATA_PATH set, phase 12's
    nuScenes tree, CP_CLI_EPOCHS epochs at its batch of 4), its test.py on
    the newest checkpoint, and test.py on the ST yaml's self-trained
    checkpoint of phase 12 with the full class list: each a subprocess
    that must exit 0; the losses finite and changing, the evaluations
    finite, the ST evaluation with its known / unknown keys."""
    from findnpropagate_torch import config as cfg_mod

    work = ROOT / CP_WORK
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    (work / "tools").symlink_to(ROOT / "tools")
    cfg_file = str(ROOT / CP_CFGS["voxel0075"])
    cfg = cfg_mod.cfg_from_yaml_file(cfg_file)
    run_dir = work / "output" / cfg.EXP_GROUP_PATH / cfg.TAG / "default"
    data = ["--set", "DATA_CONFIG.DATA_PATH", str(paper_root)]
    out = {"device": smi}
    out["train_s"], log_text = run_cli(
        "train", ["--cfg_file", cfg_file, "--epochs", str(CP_CLI_EPOCHS),
                  "--seed", "0", *data], work, "train_cli")
    losses = [float(t.split("=")[1]) for line in log_text.splitlines()
              if " it " in line and "loss=" in line
              for t in line.split() if t.startswith("loss=")]
    ckpts = sorted(p.name for p in (run_dir / "ckpt").glob(
        "checkpoint_*.pt"))
    if (len(ckpts) != CP_CLI_EPOCHS or len(losses) < 2
            or not all(math.isfinite(v) for v in losses)
            or len(set(losses)) < 2):
        raise AssertionError(f"train.py: checkpoints {ckpts}, logged "
                             f"losses {losses}")
    out["train_losses"], out["checkpoints"] = losses, ckpts
    # the yaml as written: the overflow its logged steps report
    out["train_logged_overflow"] = [
        float(t.split("=")[1]) for line in log_text.splitlines()
        if " it " in line for t in line.split()
        if t.startswith("sparse_window_overflow=")]
    out["test_s"], test_log = run_cli("test", ["--cfg_file", cfg_file,
                                               *data], work, "test_cli")
    out["test_overflow_warnings"] = test_log.count("sparse_window_overflow=")
    res = json.loads((run_dir / "eval" / "result.json").read_text())
    if not (math.isfinite(res["NDS"]) and math.isfinite(res["mAP"])
            and "recall_0.3" in res):
        raise AssertionError(f"test.py: result {res}")
    out["test_result"] = {k: v for k, v in res.items()
                          if k in ("NDS", "mAP") or k.startswith("recall")}
    # the self-trained checkpoint phase 12 left under its working dir
    st_work = ROOT / PAPER_WORK
    st_cfg = cfg_mod.cfg_from_yaml_file(str(ROOT / ST_CFG))
    st_run = st_work / "output" / st_cfg.EXP_GROUP_PATH / st_cfg.TAG \
        / "default"
    out["st_checkpoint"] = str(sorted(
        (st_run / "ckpt").glob("checkpoint_*.pt"))[-1].relative_to(ROOT))
    out["st_test_s"], _ = run_cli(
        "test", ["--cfg_file", str(ROOT / ST_CFG), "--set", "DATA_CONFIG.DATA_PATH", str(paper_root),
                 "CLASS_NAMES", ST_FULL_NAMES], st_work, "st_test_cli")
    res = json.loads((st_run / "eval" / "result.json").read_text())
    keys = ("AP_B", "AP_N", "AR_N", "NDS", "mAP", "recall_known_0.3",
            "recall_unknown_0.3")
    if not all(k in res and math.isfinite(res[k]) for k in keys):
        raise AssertionError(f"test.py on the ST checkpoint: result {res}")
    out["st_test_result"] = {k: res[k] for k in res
                             if k in keys or k.startswith("recall")}
    log(f"CLIs ({smi}): train.py {out['train_s']:.1f} s (losses {losses}, "
        f"{ckpts}, logged overflow {out['train_logged_overflow']}), test.py "
        f"{out['test_s']:.1f} s {out['test_result']} (overflow warnings "
        f"{out['test_overflow_warnings']}); "
        f"test.py on {out['st_checkpoint']} {out['st_test_s']:.1f} s "
        f"{out['st_test_result']}")
    return out


def centerpoint_phase(torch, mods, smi, args, paper_root):
    """Phase 13: CenterPoint on both nuScenes yamls at full width with its
    kernels held against their plain versions, the narrow model on the
    card against the CPU, CenterHeadCLIP and VoxelBackBone8x, and the
    port's train.py and test.py. Returns (report, rows, kernels
    entries)."""
    t0 = time.perf_counter()
    report, rows, entries = {"device": smi}, [], []
    for name in CP_CFGS:
        rep, r, e = cp_yaml_run(torch, name, mods, smi, args)
        report[name], rows, entries = rep, rows + r, entries + e
        fw, tr = rep["forward"], rep["train"]
        log(f"centerpoint {name} ({smi}): {rep['yaml']} as written; "
            + "; ".join(f"batch {b} {fw[b]['ms_per_scan']:.2f} ms/scan "
                        f"(peak {fw[b]['peak_mem_gb']:.2f} GiB, launches "
                        f"{fw[b]['launches']}, detections "
                        f"{fw[b]['detections_per_scan']})" for b in fw)
            + f"; training batch {tr['batch']} {tr['ms_per_step']:.1f} "
            f"ms/step (steps {[round(s['ms'], 1) for s in tr['steps']]}), "
            f"losses {[round(v, 3) for v in tr['losses']]}, peak "
            f"{tr['peak_mem_gb']:.2f} GiB, launches "
            f"{tr['steps'][0]['launches']}")
        log(f"centerpoint {name}: the yaml as written drops "
            f"{rep['as_written']['overflow']} neighbour spans in a batch-4 "
            f"forward (sparse_window_overflow); gated runs with the L0 "
            f"windows (as written, now) {rep['as_written']['windows']}")
        act = rep["actives"]
        log(f"centerpoint {name}: actives per level and scene "
            f"{act['per_scene']} against caps {act['caps']} "
            f"(LEVEL_CAPACITIES {act['level_capacities']}); levels at "
            f"their cap: {act['at_cap'] or 'none'}")
        if "profile" in rep:
            log(f"centerpoint {name} profile, forward batch "
                f"{max(CP_BATCHES)}: {rep['profile']}")
    report["reference"] = cp_reference(torch, mods[0], mods[2], mods[1],
                                       mods[6])
    log("centerpoint narrow model, card vs CPU: " + "; ".join(
        f"{mode}: " + ", ".join(f"{k} {v}" for k, v in r.items()
                                if k != "maps")
        for mode, r in report["reference"].items()))
    report["variants"] = cp_variants(torch, mods, smi)
    report["cli"] = cp_cli_phase(torch, smi, paper_root)
    report["phase_s"] = time.perf_counter() - t0
    log(f"centerpoint phase: {report['phase_s']:.1f} s")
    return report, rows, entries


# ---------------------------------------------------------------- datasets


WAYMO_WORK = "build/waymo"
ONCE_WORK = "build/once"
WAYMO_CFGS = {
    "centerpoint": "tools/cfgs/waymo_models/centerpoint.yaml",
    "4frames": "tools/cfgs/waymo_models/centerpoint_4frames.yaml",
    "without_resnet": "tools/cfgs/waymo_models/"
                      "centerpoint_without_resnet.yaml",
}
ONCE_CFG = "tools/cfgs/once_models/centerpoint.yaml"
# split -> (sequences, frames each): the train SAMPLED_INTERVAL of 5 leaves
# 8 of the 40 train frames, two batches of 4
WAYMO_SPLITS = {"train": (2, 20), "val": (1, 4)}
WAYMO_TOP = (64, 2650)              # beams x columns, two returns
WAYMO_SIDE = (200, 600)             # FRONT, SIDE_LEFT, SIDE_RIGHT, REAR
WAYMO_TOP_INCL = (-17.6, 2.4)       # degrees, explicit beam list
WAYMO_SIDE_INCL = (-90.0, 30.0)     # degrees, min / max only
WAYMO_SIDE_RANGE = 20.0
WAYMO_RANGE = 75.2
WAYMO_RAW_POINTS = 400000           # lidar_ring points rendered per frame
SENSOR_H = 1.84                     # lidar_ring's sensor above the ground
# laser name -> (yaw, x, y, z) of its mount on the vehicle
WAYMO_MOUNTS = {1: (0.02, 0.0, 0.0, SENSOR_H), 2: (0.0, 3.9, 0.0, 0.7),
                3: (np.pi / 2, 2.9, 0.9, 0.9), 4: (-np.pi / 2, 2.9, -0.9, 0.9),
                5: (np.pi, -1.1, 0.0, 0.9)}
WAYMO_SIZES = {"Vehicle": (4.6, 1.95, 1.7), "Pedestrian": (0.8, 0.7, 1.7),
               "Cyclist": (1.8, 0.7, 1.7), "Sign": (0.1, 0.8, 0.8),
               "unknown": (1.0, 1.0, 1.0)}
WAYMO_TYPE = {"unknown": 0, "Vehicle": 1, "Pedestrian": 2, "Sign": 3,
              "Cyclist": 4}
WAYMO_OBJECTS = 40
# ONCE: split -> (sequence id, frames); MAX_POINTS 120000 of the yaml
ONCE_SPLITS = {"train": ("000076", 8), "val": ("000080", 4)}
ONCE_POINTS = 150000
ONCE_SIZES = {"Car": (4.6, 1.95, 1.7), "Bus": (11.0, 2.9, 3.3),
              "Truck": (7.0, 2.5, 2.8), "Pedestrian": (0.8, 0.7, 1.7),
              "Cyclist": (1.8, 0.7, 1.7)}


def rot_z(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def waymo_extrinsic(name):
    yaw, x, y, z = WAYMO_MOUNTS[name]
    e = np.eye(4)
    e[:3, :3] = rot_z(yaw)
    e[:3, 3] = (x, y, z)
    return e


def render_range_image(points, extra, extrinsic, incl_rows, width,
                       max_range, returns=1, facing=False):
    """Vehicle-frame points -> `returns` (H, W, 4) range images [range,
    intensity, elongation, NLZ]: tests/test_waymo_infos.py's
    _render_range_image vectorised. A point lands on the nearest beam row
    (incl_rows: row 0 = top beam; points beyond half a row of the span are
    dropped) and on the column of its azimuth; per pixel the nearest point
    is the first return and the next the second. `facing` keeps the points
    in front of the sensor (x > 0 in its frame). Returns (images, the
    indices of the points drawn)."""
    h = len(incl_rows)
    ps = (points - extrinsic[:3, 3]) @ extrinsic[:3, :3]
    r = np.linalg.norm(ps, axis=1)
    ok = (r > 1.0) & (r < max_range)
    if facing:
        ok &= ps[:, 0] > 0
    incl = np.arcsin(np.clip(ps[:, 2] / np.maximum(r, 1e-9), -1, 1))
    asc = np.asarray(incl_rows)[::-1]
    j = np.clip(np.searchsorted(asc, incl), 1, h - 1)
    k = np.where(np.abs(incl - asc[j - 1]) <= np.abs(incl - asc[j]),
                 j - 1, j)
    ok &= (incl >= asc[0] - (asc[1] - asc[0]) / 2) \
        & (incl <= asc[-1] + (asc[-1] - asc[-2]) / 2)
    az = np.arctan2(ps[:, 1], ps[:, 0])
    az_corr = np.arctan2(extrinsic[1, 0], extrinsic[0, 0])
    col = np.round(width - 0.5 - (az + az_corr + np.pi) * width
                   / (2 * np.pi)).astype(np.int64) % width
    pix = (h - 1 - k) * width + col
    idx = np.flatnonzero(ok)
    # by pixel, then by range (r / max_range < 1)
    order = idx[np.argsort(pix[idx] + r[idx] / max_range, kind="stable")]
    p = pix[order]
    starts = np.flatnonzero(np.r_[True, p[1:] != p[:-1]])
    rank = np.arange(len(p)) - np.repeat(starts, np.diff(np.r_[starts,
                                                               len(p)]))
    images, drawn = [], []
    vals = np.concatenate([r[:, None], extra], axis=1).astype(np.float32)
    for ret in range(returns):
        sel = order[rank == ret]
        img = np.zeros((h * width, 4), np.float32)
        img[pix[sel]] = vals[sel]
        images.append(img.reshape(h, width, 4))
        drawn.append(sel)
    return images, np.concatenate(drawn)


def pose_matrix(yaw, x, y):
    pose = np.eye(4)
    pose[:3, :3] = rot_z(yaw)
    pose[:3, 3] = (x, y, 0.0)
    return pose


def waymo_world(seed, n_objects, pcr):
    """One sequence's objects in the world frame (the first frame's vehicle
    frame): names, (n, 7) boxes on the ground, and the Sign and unknown
    labels the loader drops."""
    rng = np.random.RandomState(seed)
    names = [("Vehicle", "Pedestrian", "Cyclist")[rng.randint(3)]
             for _ in range(n_objects)] + ["Sign", "unknown"]
    boxes = np.zeros((len(names), 7))
    margin = 4.0
    boxes[:, 0] = rng.uniform(pcr[0] + margin, pcr[3] - margin, len(names))
    boxes[:, 1] = rng.uniform(pcr[1] + margin, pcr[4] - margin, len(names))
    boxes[:, 3:6] = [WAYMO_SIZES[n] for n in names]
    boxes[:, 3:6] *= rng.uniform(0.9, 1.1, (len(names), 3))
    boxes[:, 2] = boxes[:, 5] / 2
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, len(names))
    return names, boxes


def waymo_frame(args):
    """One Frame's bytes: bench.py's lidar_ring scene of the sequence's
    objects seen from the frame's pose, rendered into the TOP lidar (two
    returns, the pixel pose) and the four side lidars (facing, within
    WAYMO_SIDE_RANGE); labels with their drawn point counts."""
    from findnpropagate_torch.datasets import waymo_proto as wp
    from findnpropagate_torch.datasets.synthetic import lidar_ring_points
    from findnpropagate_torch.utils.geometry_np import points_in_boxes_mask

    (seq, seed, t, pcr, top, side, raw_points, n_objects) = args
    names, world = waymo_world(seed, n_objects, pcr)
    pose = pose_matrix(0.3 + 0.01 * t, 1.0 * t * np.cos(0.3),
                       1.0 * t * np.sin(0.3))
    boxes = world.copy()
    boxes[:, :3] = (world[:, :3] - pose[:3, 3]) @ pose[:3, :3]
    boxes[:, 6] = world[:, 6] - (0.3 + 0.01 * t)
    rng = np.random.RandomState(seed)
    sensor = boxes.astype(np.float32).copy()
    sensor[:, 2] -= SENSOR_H
    pts = lidar_ring_points(rng, sensor[:, :7], raw_points)
    xyz = pts[:, :3].astype(np.float64) + [0.0, 0.0, SENSOR_H]
    extra = np.stack([2.0 * pts[:, 3], rng.uniform(0, 0.3, len(pts)),
                      np.where(rng.uniform(size=len(pts)) < 0.02, 1.0,
                               -1.0)], axis=1)
    lasers, calibs, drawn = [], [], []
    top_incl = np.deg2rad(np.linspace(*WAYMO_TOP_INCL, top[0]))
    side_incl = np.deg2rad(WAYMO_SIDE_INCL)
    for name in sorted(WAYMO_MOUNTS):
        extr = waymo_extrinsic(name)
        if name == wp.LASER_TOP:
            (r1, r2), d = render_range_image(xyz, extra, extr,
                                             top_incl[::-1], top[1],
                                             WAYMO_RANGE, returns=2)
            rpy = np.zeros((top[0], top[1], 6), np.float32)
            rpy[..., 2] = 0.3 + 0.01 * t
            rpy[..., 3:] = pose[:3, 3]
            lasers.append(wp.encode_laser(
                name, wp.encode_range_image(r1, pose=rpy),
                wp.encode_range_image(r2)))
            calibs.append(wp.encode_laser_calibration(
                name, extr, beam_inclinations=top_incl))
        else:
            incl = np.linspace(side_incl[0], side_incl[1], side[0] + 1)
            incl = (incl[:-1] + incl[1:]) / 2       # compute_inclination's
            (r1,), d = render_range_image(xyz, extra, extr, incl[::-1],
                                          side[1], WAYMO_SIDE_RANGE,
                                          facing=True)
            lasers.append(wp.encode_laser(name, wp.encode_range_image(r1)))
            calibs.append(wp.encode_laser_calibration(
                name, extr, incl_min=side_incl[0], incl_max=side_incl[1]))
        drawn.append(d)
    drawn = np.unique(np.concatenate(drawn))
    counts = points_in_boxes_mask(xyz[drawn], boxes).sum(axis=1)
    labels = [wp.encode_label(b[:3], b[3:6], b[6], WAYMO_TYPE[n],
                              f"{seq}_{i}", num_points=int(c))
              for i, (b, n, c) in enumerate(zip(boxes, names, counts))]
    return wp.encode_frame(seq, 1_550_000_000_000_000 + 100_000 * t, pose,
                           calibs, lasers, labels)


def write_waymo_tree(root, splits=None, top=WAYMO_TOP, side=WAYMO_SIDE,
                     raw_points=WAYMO_RAW_POINTS, n_objects=WAYMO_OBJECTS,
                     workers=0, pcr=(-WAYMO_RANGE, -WAYMO_RANGE, -2.0,
                                     WAYMO_RANGE, WAYMO_RANGE, 4.0)):
    """A raw Waymo tree under `root`: raw_data/<seq>.tfrecord written by
    the port's waymo_proto encoders, ImageSets/<split>.txt. `splits`:
    split -> (sequences, frames each). Frames render in `workers` spawned
    processes (0: in this one). Returns {split: [sequence file names]}."""
    from findnpropagate_torch.datasets import waymo_proto as wp

    splits = splits or WAYMO_SPLITS
    (root / "raw_data").mkdir(parents=True, exist_ok=True)
    (root / "ImageSets").mkdir(exist_ok=True)
    jobs, seqs = [], {}
    for si, (split, (n_seq, n_frames)) in enumerate(splits.items()):
        for k in range(n_seq):
            seq = f"segment-{1000 * si + k:07d}_with_camera_labels"
            seqs.setdefault(split, []).append(seq + ".tfrecord")
            jobs += [(seq, 7000 + 100 * si + k, t, pcr, top, side,
                      raw_points, n_objects) for t in range(n_frames)]
    if workers:
        with concurrent.futures.ProcessPoolExecutor(
                workers, mp_context=multiprocessing.get_context("spawn")) \
                as pool:
            frames = list(pool.map(waymo_frame, jobs))
    else:
        frames = [waymo_frame(j) for j in jobs]
    for split, files in seqs.items():
        for f in files:
            wp.write_tfrecord(root / "raw_data" / f,
                              [fr for j, fr in zip(jobs, frames)
                               if j[0] + ".tfrecord" == f])
        (root / "ImageSets" / f"{split}.txt").write_text(
            "\n".join(files) + "\n")
    return seqs


def write_once_tree(root, splits=None, raw_points=ONCE_POINTS,
                    n_objects=WAYMO_OBJECTS, pcr=(-75.2, -75.2, -5.0, 75.2,
                                                  75.2, 3.0)):
    """A raw ONCE tree under `root`: ImageSets/<split>.txt, per sequence
    data/<seq>/<seq>.json (meta_info, cam01's calibration, frames with
    their pose and annos: names, boxes_3d, boxes_2d) and
    data/<seq>/lidar_roof/<frame>.bin, bench.py's lidar_ring scenes (x y z
    intensity) with objects of the five ONCE classes. Returns the number
    of points per frame."""
    from findnpropagate_torch.datasets.synthetic import lidar_ring_points

    splits = splits or ONCE_SPLITS
    (root / "ImageSets").mkdir(parents=True, exist_ok=True)
    counts = []
    for si, (split, (seq, n_frames)) in enumerate(splits.items()):
        (root / "ImageSets" / f"{split}.txt").write_text(seq + "\n")
        lidar = root / "data" / seq / "lidar_roof"
        lidar.mkdir(parents=True, exist_ok=True)
        frames = []
        for t in range(n_frames):
            rng = np.random.RandomState(9000 + 100 * si + t)
            names = [list(ONCE_SIZES)[rng.randint(len(ONCE_SIZES))]
                     for _ in range(n_objects)]
            boxes = np.zeros((n_objects, 7))
            boxes[:, 0] = rng.uniform(pcr[0] + 4, pcr[3] - 4, n_objects)
            boxes[:, 1] = rng.uniform(pcr[1] + 4, pcr[4] - 4, n_objects)
            boxes[:, 3:6] = [ONCE_SIZES[n] for n in names]
            boxes[:, 2] = boxes[:, 5] / 2 - SENSOR_H
            boxes[:, 6] = rng.uniform(-np.pi, np.pi, n_objects)
            pts = lidar_ring_points(rng, boxes.astype(np.float32),
                                    raw_points)
            fid = str(1_616_000_000_000 + 100_000 * (50 * si + t))
            pts.tofile(lidar / f"{fid}.bin")
            counts.append(len(pts))
            frames.append({
                "frame_id": fid,
                "pose": [0.0, 0.0, 0.0, 1.0, 1.5 * t, 0.0, 0.0],
                "annos": {"names": names, "boxes_3d": boxes.tolist(),
                          "boxes_2d": {"cam01": [[10.0, 10.0, 60.0, 40.0]]
                                       * n_objects}}})
        seq_json = {
            "meta_info": {"weather": "sunny", "period": "morning"},
            "calib": {"cam01": {
                "cam_to_velo": np.eye(4).tolist(),
                "cam_intrinsic": [[900.0, 0, 960], [0, 900.0, 540],
                                  [0, 0, 1]],
                "distortion": [0.0] * 7}},
            "frames": frames}
        (root / "data" / seq / f"{seq}.json").write_text(
            json.dumps(seq_json))
    return counts


MISC_CFGS = {
    "LyftDataset": "tools/cfgs/dataset_configs/lyft_dataset.yaml",
    "CustomDataset": "tools/cfgs/dataset_configs/custom_dataset.yaml",
    "Argo2Dataset": "tools/cfgs/dataset_configs/argo2_dataset.yaml",
    "PandasetDataset": "tools/cfgs/dataset_configs/pandaset_dataset.yaml",
}
MISC_WORK = "build/misc"
# class names per dataset for MISC_SIZES' four kinds in turn (the last
# kind takes the first name again where three are given); the Lyft tree's
# categories are nuScenes' general names
MISC_NAMES = {"LyftDataset": ("vehicle.car", "vehicle.truck",
                              "human.pedestrian.adult", "vehicle.bicycle"),
              "CustomDataset": ("Vehicle", "Pedestrian", "Cyclist"),
              "Argo2Dataset": ("Regular_vehicle", "Pedestrian", "Bicyclist"),
              "PandasetDataset": ("Car", "Pedestrian", "Bicycle")}
MISC_SIZES = {"car": (4.6, 1.95, 1.7), "truck": (7.0, 2.5, 2.8),
              "pedestrian": (0.8, 0.7, 1.7), "bicycle": (1.8, 0.7, 1.3)}
MISC_FRAMES = 2                 # per split
MISC_POINTS = 120000
MISC_SWEEPS = 5                 # lyft_dataset.yaml's MAX_SWEEPS


def misc_scenes(n_frames, seed, points, n_objects, reach=40.0):
    """bench.py's lidar_ring scenes in the lidar frame, objects of
    MISC_SIZES' four kinds within `reach` metres: [(points (N, 4) float32,
    boxes (M, 7), kinds)]."""
    from findnpropagate_torch.datasets.synthetic import lidar_ring_points

    out = []
    for i in range(n_frames):
        rng = np.random.RandomState(seed + i)
        kinds = [list(MISC_SIZES)[rng.randint(len(MISC_SIZES))]
                 for _ in range(n_objects)]
        boxes = np.zeros((n_objects, 7))
        boxes[:, :2] = rng.uniform(-reach, reach, (n_objects, 2))
        boxes[:, 3:6] = [MISC_SIZES[k] for k in kinds]
        boxes[:, 2] = boxes[:, 5] / 2 - SENSOR_H
        boxes[:, 6] = rng.uniform(-np.pi, np.pi, n_objects)
        out.append((lidar_ring_points(rng, boxes.astype(np.float32), points),
                    boxes, kinds))
    return out


def write_misc_trees(root, frames=MISC_FRAMES, points=MISC_POINTS,
                     n_objects=WAYMO_OBJECTS, sweeps=MISC_SWEEPS):
    """Trees of the four info-pkl datasets under root/<lyft, custom,
    argo2, pandaset>, `frames` train and `frames` val frames each: Lyft as
    its raw release (nuScenes-schema tables under trainval/data with
    chains of `sweeps` - 1 sweeps, ImageSets; its infos come from
    create_infos lyft), the other three as their info pickles and point
    files, written directly as tests/test_misc_datasets.py writes them.
    Returns {dataset: root of its tree}."""
    from findnpropagate_torch.utils.geometry_np import points_in_boxes_mask

    scenes = misc_scenes(2 * frames, 5100, points, n_objects)
    roots = {}
    lyft = root / "lyft" / "trainval"
    write_nuscenes_tree(lyft, [[(p, b.astype(np.float32), k)
                                for p, b, k in scenes[:frames]],
                               [(p, b.astype(np.float32), k)
                                for p, b, k in scenes[frames:]]],
                        sweeps, np.random.RandomState(0))
    (lyft / NUS_VERSION).rename(lyft / "data")
    (root / "lyft" / "ImageSets").mkdir(exist_ok=True)
    (root / "lyft" / "ImageSets" / "train.txt").write_text("scene-0000\n")
    (root / "lyft" / "ImageSets" / "val.txt").write_text("scene-0001\n")
    roots["LyftDataset"] = lyft
    for ds in ("CustomDataset", "Argo2Dataset", "PandasetDataset"):
        names = MISC_NAMES[ds]
        d = root / ds.replace("Dataset", "").lower()
        roots[ds] = d
        for split, part in (("train", scenes[:frames]),
                            ("val", scenes[frames:])):
            infos = []
            for i, (pts, boxes, kinds) in enumerate(part):
                idx = f"{split}_{i:03d}"
                pts = pts.copy()
                pts[:, 2] += SENSOR_H
                gt = boxes.astype(np.float32).copy()
                gt[:, 2] += SENSOR_H
                name = np.array([names[list(MISC_SIZES).index(k)
                                       % len(names)] for k in kinds],
                                dtype=object)
                if ds == "CustomDataset":
                    (d / "points").mkdir(parents=True, exist_ok=True)
                    np.save(d / "points" / f"{idx}.npy", pts)
                    infos.append({"point_cloud": {"lidar_idx": idx},
                                  "annos": {"name": name,
                                            "gt_boxes_lidar": gt}})
                elif ds == "Argo2Dataset":
                    rel = f"training/velodyne/{idx}.bin"
                    (d / rel).parent.mkdir(parents=True, exist_ok=True)
                    pts.tofile(d / rel)
                    npts = points_in_boxes_mask(pts[:, :3], gt).sum(axis=1)
                    infos.append({"point_cloud": {"velodyne_path": rel},
                                  "annos": {"name": name,
                                            "gt_boxes_lidar": gt,
                                            "num_points_in_gt":
                                                npts.astype(np.int32)}})
                else:
                    (d / "preprocessed").mkdir(parents=True, exist_ok=True)
                    np.save(d / "preprocessed" / f"{idx}.npy", pts)
                    infos.append({"sequence": split, "frame_idx": i,
                                  "points_path": f"preprocessed/{idx}.npy",
                                  "gt_boxes": gt, "gt_names": name})
            prefix = ds.replace("Dataset", "").lower()
            with open(d / f"{prefix}_infos_{split}.pkl", "wb") as f:
                pickle.dump(infos, f)
    return roots


def misc_cfg(cfg_mod, ds, root):
    """The dataset's yaml with its tree's DATA_PATH (and, for Lyft, the
    sweeps the tree has)."""
    cfg = cfg_mod.cfg_from_yaml_file(str(ROOT / MISC_CFGS[ds]))
    cfg.DATA_PATH = str(root)
    return cfg


def gt_as_detections(ds):
    """Each info's ground truth as detections, scored 1 to 0.5, with its
    names and its labels (1-indexed into the dataset's class names, 0 for
    the others); boxes the evaluation drops for holding no point are left
    out."""
    dets = []
    for info in ds.infos:
        annos = info.get("annos", info)
        boxes = np.asarray(annos.get("gt_boxes_lidar",
                                     annos.get("gt_boxes")))[:, :7]
        names = np.asarray(annos.get("name", annos.get("gt_names")))
        if annos.get("num_points_in_gt") is not None:
            keep = np.asarray(annos["num_points_in_gt"]) > 0
            boxes, names = boxes[keep], names[keep]
        dets.append({"boxes": boxes.astype(np.float32),
                     "scores": np.linspace(1.0, 0.5, len(boxes)),
                     "name": names,
                     "labels": np.array([ds.class_names.index(n) + 1
                                         if n in ds.class_names else 0
                                         for n in names], np.int64)})
    return dets


# per yaml: (launches a forward, launches a step), as phase 13's
WAYMO_LAUNCHES = {
    "centerpoint": (CP_EVAL_LAUNCHES["voxel0075"], PALLAS_TRAIN_LAUNCHES),
    "4frames": (EVAL_LAUNCHES, TRAIN_LAUNCHES),
    "without_resnet": (PLAIN_EVAL_LAUNCHES, PLAIN_TRAIN_LAUNCHES),
}
WAYMO_TRAIN_STEPS = 2           # timed, after a warm-up step
# the gated runs' windows (cp_widen's levels, factor): the main path's at
# every level; twice those for four stacked frames, whose training batch
# drops neighbours at the main path's L0 -> L1 strided window (4608: 2 + 3
# blocks, both directions, on an NVIDIA H100 80GB HBM3 at 700 W)
WAYMO_WIDEN = {"centerpoint": (3, 1), "4frames": (3, 2),
               "without_resnet": (3, 1)}
# create_infos writes waymo_processed_data/, the yamls read this tag
WAYMO_TAG = "waymo_processed_data_v0_5_0"
WAYMO_CLASSES = ("Vehicle", "Pedestrian", "Cyclist")
DS_CLI_EPOCHS = 1


def tree_data(TD, root, stats):
    """cp_yaml_run's data from a dataset tree: the yaml's dataset with
    DATA_PATH `root` through the port's build_dataloader (no prefetch), its
    first batch; per call, the samples' point counts before collation
    (stats[training])."""
    def data(cfg, training, n):
        cfg.DATA_CONFIG.DATA_PATH = str(root)
        ds, loader, _ = TD.build_dataloader(
            cfg.DATA_CONFIG, list(cfg.CLASS_NAMES), batch_size=n,
            training=training, seed=0, prefetch=0)
        counts = stats.setdefault(training, [])
        collate = ds.collate_batch

        def counted(samples):
            counts.extend(len(s["points"]) for s in samples)
            return collate(samples)
        ds.collate_batch = counted
        t0 = time.perf_counter()
        batch = next(iter(loader))
        ms = (time.perf_counter() - t0) * 1e3
        del ds.collate_batch
        batch.pop("frame_id")
        batch.pop("batch_size")
        return ds, batch, ms
    return data


def train_test_clis(cfg_mod, work, data, yaml, label):
    """train.py (DS_CLI_EPOCHS epoch) and test.py on its checkpoint, the
    yaml as written with only DATA_CONFIG.DATA_PATH set, as subprocesses in
    `work`: their wall seconds, the logged losses and overflow, the
    checkpoints and the evaluation's result; raises unless both exit 0,
    the losses are finite and a checkpoint is written."""
    if not (work / "tools").exists():
        (work / "tools").symlink_to(ROOT / "tools")
    cfg_file = str(ROOT / yaml)
    cfg = cfg_mod.cfg_from_yaml_file(cfg_file)
    run_dir = work / "output" / cfg.EXP_GROUP_PATH / cfg.TAG / "default"
    setting = ["--set", "DATA_CONFIG.DATA_PATH", str(data)]
    out = {}
    out["train_s"], log_text = run_cli(
        "train", ["--cfg_file", cfg_file, "--epochs", str(DS_CLI_EPOCHS),
                  "--seed", "0", *setting], work, f"{label}_train_cli")
    lines = [line for line in log_text.splitlines() if " it " in line]
    out["train_losses"] = [float(t.split("=")[1]) for line in lines
                           for t in line.split() if t.startswith("loss=")]
    out["train_logged_overflow"] = [
        float(t.split("=")[1]) for line in lines for t in line.split()
        if t.startswith("sparse_window_overflow=")]
    out["checkpoints"] = sorted(p.name for p in (run_dir / "ckpt").glob(
        "checkpoint_*.pt"))
    if not (out["checkpoints"] and out["train_losses"] and all(
            math.isfinite(v) for v in out["train_losses"])):
        raise AssertionError(f"{label} train.py: checkpoints "
                             f"{out['checkpoints']}, losses "
                             f"{out['train_losses']}")
    out["test_s"], test_log = run_cli("test", ["--cfg_file", cfg_file,
                                               *setting], work,
                                      f"{label}_test_cli")
    out["test_overflow_warnings"] = test_log.count("sparse_window_overflow=")
    out["result"] = json.loads((run_dir / "eval" / "result.json").read_text())
    return out


def kitti_clis(cfg_mod, smi, work, jobs):
    """train.py (DS_CLI_EPOCHS epoch) and test.py on phase 15's KITTI tree
    for each yaml of `jobs` ({label: yaml}) as written with only DATA_PATH
    set, the chains side by side in the directory `work`: a checkpoint,
    finite losses and every KITTI AP key finite. Returns {label:
    train_test_clis' report}."""
    if not (work / "tools").exists():
        (work / "tools").symlink_to(ROOT / "tools")     # before the chains

    def chain(label):
        return label, train_test_clis(cfg_mod, work, KITTI_TREE,
                                      jobs[label], label.replace(" ", "_"))
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        clis = dict(pool.map(chain, list(jobs)))
    for label, cli in clis.items():
        res = cli["result"]
        if not ("mAP_3d_moderate_R40" in res and all(
                math.isfinite(v) for v in res.values())):
            raise AssertionError(f"{label} test.py: result {res}")
        log(f"{label} CLIs ({smi}; {len(jobs)} yamls' chains side by side):"
            f" train.py {cli['train_s']:.1f} s (losses "
            f"{cli['train_losses']}, {cli['checkpoints']}), test.py "
            f"{cli['test_s']:.1f} s, mAP_3d_moderate_R40 "
            f"{res['mAP_3d_moderate_R40']}, {len(res)} keys all finite")
    return clis


def waymo_phase(torch, mods, smi, args, TD, device="cuda"):
    """Phase 14's Waymo part: the raw tree (write_waymo_tree in spawned
    processes), create_infos waymo --gt_database as a subprocess, the
    three Waymo CenterPoint yamls through WaymoDataset on it, and train.py
    / test.py on centerpoint.yaml. Returns (report, rows, entries)."""
    cfg_mod = mods[0]
    work = ROOT / WAYMO_WORK
    shutil.rmtree(work, ignore_errors=True)
    data_root = work / "data"
    rep = {}
    t0 = time.perf_counter()
    seqs = write_waymo_tree(data_root, workers=min(8, os.cpu_count() or 1))
    rep["write_s"] = time.perf_counter() - t0
    n_frames = sum(n * f for n, f in WAYMO_SPLITS.values())
    wall, _ = run_cli("create_infos", ["waymo", "--data_path",
                                       str(data_root), "--gt_database"],
                      work, "create_infos_waymo")
    rep["create_infos_s"] = wall
    rep["create_infos_s_per_frame"] = wall / n_frames
    (data_root / WAYMO_TAG).symlink_to("waymo_processed_data")
    with open(data_root / "waymo_dbinfos_train.pkl", "rb") as f:
        db = pickle.load(f)
    rep["gt_database"] = {k: len(v) for k, v in db.items()}
    if not set(WAYMO_CLASSES) <= set(db):
        raise AssertionError(f"waymo gt database: {rep['gt_database']}")
    frames = []
    for split, files in seqs.items():
        for f in files:
            seq = f[:-len(".tfrecord")]
            with open(data_root / "waymo_processed_data" / seq
                      / f"{seq}.pkl", "rb") as fh:
                frames += [sum(i["num_points_of_each_lidar"])
                           for i in pickle.load(fh)]
    rep["points_per_frame"] = [min(frames), max(frames)]
    log(f"waymo tree ({smi}): {n_frames} frames written in "
        f"{rep['write_s']:.1f} s, {min(frames)}-{max(frames)} points a "
        f"frame; create_infos waymo --gt_database {wall:.1f} s "
        f"({rep['create_infos_s_per_frame']:.3f} s a frame), gt database "
        f"{rep['gt_database']}")

    rows, entries = [], []
    for name, yaml in WAYMO_CFGS.items():
        stats = {}
        r, rw, e = cp_yaml_run(
            torch, name, mods, smi, types.SimpleNamespace(
                reps=args.reps, profile=None), device=device, yaml=yaml,
            data=tree_data(TD, data_root, stats),
            launches=WAYMO_LAUNCHES[name],
            steps=WAYMO_TRAIN_STEPS if name != "without_resnet" else 1,
            label="waymo", record=name != "without_resnet",
            widen=WAYMO_WIDEN[name], exact_gate=True)
        r["points_before_collation"] = stats
        rep[name], rows, entries = r, rows + rw, entries + e
        fw, tr = r["forward"], r["train"]
        log(f"waymo {name} ({smi}): {yaml} as written; "
            + "; ".join(f"batch {b} {fw[b]['ms_per_scan']:.2f} ms/scan "
                        f"(peak {fw[b]['peak_mem_gb']:.2f} GiB, launches "
                        f"{fw[b]['launches']})" for b in fw)
            + f"; training batch {tr['batch']} {tr['ms_per_step']:.1f} "
            f"ms/step, losses {[round(v, 3) for v in tr['losses']]}, peak "
            f"{tr['peak_mem_gb']:.2f} GiB, launches "
            f"{tr['warm_up']['launches']}; loader host ms per batch: eval "
            f"{r['loader_ms_eval_batch']:.1f}, train "
            f"{r['loader_ms_train_batch']:.1f}; points per scan "
            f"{r['points_per_scan']} (before collation {stats})")
        act = r["actives"]
        log(f"waymo {name}: as written, {r['as_written']['overflow']} "
            f"neighbour spans dropped in a batch-4 forward ([kind, window, "
            f"targets, counter, real]: {r['as_written']['dropped_at']}); "
            f"the training batch's counter "
            f"{tr['warm_up']['sparse_window_overflow']} "
            f"({tr['warm_up']['dropped_at']}); windows "
            f"(as written, gated runs) {r['as_written']['windows']}; actives "
            f"per level and scene {act['per_scene']} against caps "
            f"{act['caps']} (LEVEL_CAPACITIES {act['level_capacities']}); "
            f"levels at their cap: {act['at_cap'] or 'none'}")
    # the 4-frame yaml's stacked sweeps: the time channel of the last val
    # frame (earlier ones repeat frame 0 for the sweeps before it)
    stats = {}
    cfg = cfg_mod.cfg_from_yaml_file(str(ROOT / WAYMO_CFGS["4frames"]))
    _, batch, _ = tree_data(TD, data_root, stats)(cfg, False, 4)
    t = batch["points"][3, batch["points_mask"][3], -1]
    rep["4frames"]["time_channel"] = {
        f"{v:.1f}": int((np.round(t, 1) == np.round(v, 1)).sum())
        for v in np.unique(np.round(t, 1))}
    if len(rep["4frames"]["time_channel"]) != 4:
        raise AssertionError(f"4frames: time channel "
                             f"{rep['4frames']['time_channel']}")
    log(f"waymo 4frames: stacked points {stats[False]}, points per time "
        f"lag (s) {rep['4frames']['time_channel']}")

    cli = train_test_clis(cfg_mod, work, data_root,
                          WAYMO_CFGS["centerpoint"], "waymo")
    keys = [f"OBJECT_TYPE_TYPE_{c.upper()}_LEVEL_{lvl}/{m}"
            for c in WAYMO_CLASSES for lvl in (1, 2) for m in ("AP", "APH")]
    if not all(k in cli["result"] and math.isfinite(cli["result"][k])
               for k in keys):
        raise AssertionError(f"waymo test.py: result {cli['result']}")
    rep["cli"] = cli
    log(f"waymo CLIs ({smi}): train.py {cli['train_s']:.1f} s (losses "
        f"{cli['train_losses']}, {cli['checkpoints']}, logged overflow "
        f"{cli['train_logged_overflow']}), test.py {cli['test_s']:.1f} s "
        f"(overflow warnings {cli['test_overflow_warnings']}) "
        f"{cli['result']}")
    return rep, rows, entries


def once_phase(torch, mods, smi):
    """Phase 14's ONCE part: the raw tree, create_infos once, train.py and
    test.py on tools/cfgs/once_models/centerpoint.yaml, as subprocesses."""
    cfg_mod = mods[0]
    work = ROOT / ONCE_WORK
    shutil.rmtree(work, ignore_errors=True)
    data_root = work / "data"
    rep = {"points_per_frame": write_once_tree(data_root)}
    rep["create_infos_s"], _ = run_cli(
        "create_infos", ["once", "--data_path", str(data_root)], work,
        "create_infos_once")
    cli = train_test_clis(cfg_mod, work, data_root, ONCE_CFG, "once")
    res = cli["result"]
    if not (res and "AP_mean/overall" in res
            and all(math.isfinite(v) for v in res.values())):
        raise AssertionError(f"once test.py: result {res}")
    rep["cli"] = cli
    log(f"once ({smi}): {sum(f for _, f in ONCE_SPLITS.values())} frames "
        f"of {min(rep['points_per_frame'])}-{max(rep['points_per_frame'])} "
        f"points; create_infos once {rep['create_infos_s']:.1f} s; "
        f"train.py {cli['train_s']:.1f} s (losses {cli['train_losses']}, "
        f"logged overflow {cli['train_logged_overflow']}), test.py "
        f"{cli['test_s']:.1f} s {res} (the CLI's detections carry no names: "
        f"once_eval scores none of them)")
    return rep


def misc_phase(torch, smi, cfg_mod, TD, device="cuda"):
    """Phase 14's Lyft, Custom, Argo2 and Pandaset part: their trees
    (Lyft's infos through create_infos lyft), one training batch of each
    through build_dataloader moved to the card, and each evaluation of the
    ground truth as detections: Lyft and Argo2 mAP 1, Custom's KITTI AP 0
    (its infos carry no 2D boxes) and Pandaset's empty result, as in the
    JAX package, their simple mAP perfect (100 / 101)."""
    from findnpropagate_torch.tools import create_infos

    work = ROOT / MISC_WORK
    shutil.rmtree(work, ignore_errors=True)
    roots = write_misc_trees(work)
    create_infos.main(["lyft", "--data_path", str(roots["LyftDataset"]),
                       "--max_sweeps", str(MISC_SWEEPS)])
    out = {}
    for name, root in roots.items():
        cfg = misc_cfg(cfg_mod, name, root)
        names = list(MISC_NAMES[name])
        ds, loader, _ = TD.build_dataloader(cfg, names, batch_size=2,
                                            training=True, prefetch=0)
        t0 = time.perf_counter()
        batch = next(iter(loader))
        host_ms = (time.perf_counter() - t0) * 1e3
        card = {k: torch.from_numpy(v).to(device) for k, v in batch.items()
                if isinstance(v, np.ndarray)}
        n_pts = [int(v) for v in card["points_mask"].sum(1)]
        n_gt = [int(v) for v in (card["gt_boxes"][..., 7] > 0).sum(1)]
        if not (bool(torch.isfinite(card["points"]).all()) and min(n_pts)
                and min(n_gt)):
            raise AssertionError(f"{name}: batch points {n_pts} gt {n_gt}")
        tds = type(ds)(cfg, names, training=False)
        dets = gt_as_detections(tds)
        _, res = tds.evaluation(copy.deepcopy(dets), names)
        _, simple = tds.evaluation(copy.deepcopy(dets), names,
                                   eval_metric="simple")
        ok = {"LyftDataset": lambda: abs(res["mAP"] - 1.0) < 1e-9,
              "Argo2Dataset": lambda: abs(res["mAP"] - 1.0) < 1e-9,
              "CustomDataset": lambda: all(v == 0.0 for v in res.values()),
              "PandasetDataset": lambda: res == {}}[name]()
        if name in ("CustomDataset", "PandasetDataset"):
            ok = ok and abs(simple["mAP"] - 100 / 101) < 1e-9
        if not ok:
            raise AssertionError(f"{name}: evaluation of the ground truth "
                                 f"{res} (simple {simple})")
        out[name] = {"points": n_pts, "gt": n_gt, "loader_ms": host_ms,
                     "mAP": res.get("mAP", res.get("mAP_3d_moderate_R40")),
                     "simple_mAP": simple["mAP"]}
    log(f"misc datasets ({smi}): " + "; ".join(
        f"{k} batch points {v['points']} gt {v['gt']} loader "
        f"{v['loader_ms']:.1f} ms, ground truth scored {v['mAP']} (simple "
        f"{v['simple_mAP']:.4f})" for k, v in out.items()))
    return out


def datasets_phase(torch, mods, smi, args, device="cuda"):
    """Phase 14: Waymo, ONCE and the misc datasets. Returns (report, rows,
    kernels entries)."""
    from findnpropagate_torch import datasets as TD

    t0 = time.perf_counter()
    report = {"device": smi}
    report["waymo"], rows, entries = waymo_phase(torch, mods, smi, args, TD,
                                                 device)
    report["once"] = once_phase(torch, mods, smi)
    report["misc"] = misc_phase(torch, smi, mods[0], TD, device)
    report["phase_s"] = time.perf_counter() - t0
    log(f"datasets phase: {report['phase_s']:.1f} s")
    return report, rows, entries



# ---------------------------------------------------------------- phase 15

ANCHOR_WORK = "build/anchor"
KITTI_TREE = ROOT / ANCHOR_WORK / "kitti" / "data"    # read by phases 16-18
ANCHOR_KITTI = {"pointpillar": "tools/cfgs/kitti_models/pointpillar.yaml",
                "second": "tools/cfgs/kitti_models/second.yaml"}
ANCHOR_LYFT = "tools/cfgs/lyft_models/cbgs_second_multihead.yaml"
# phase 12's nuScenes tree: yaml and whether a training step is taken
ANCHOR_NUS = {
    "cbgs_pp_multihead": (
        "tools/cfgs/nuscenes_models/cbgs_pp_multihead.yaml", False),
    "centerpoint_pillar": (
        "tools/cfgs/nuscenes_models/centerpoint_pillar.yaml", True),
    "cbgs_dyn_pp_centerpoint": (
        "tools/cfgs/nuscenes_models/cbgs_dyn_pp_centerpoint.yaml", True)}
ANCHOR_WAYMO = "tools/cfgs/waymo_models/pointpillar_1x.yaml"
ANCHOR_BATCHES = (1, 4)
ANCHOR_REPS = 3                  # timed forwards after 2 warm-ups
ANCHOR_TRAIN_STEPS = 2           # timed KITTI steps after a warm-up step
KITTI_CLASSES = ("Car", "Pedestrian", "Cyclist")
KITTI_SPLITS = {"train": 8, "val": 4}
KITTI_OBJECTS = 12
KITTI_IMAGE = (1242, 375)
NO_LAUNCHES = {"positions": 0, "posgather_conv": 0, "windowed_conv": 0,
               "windowed_dw": 0}
# trait (a): the multi-head yamls' 8 to 11 code weights meet the 7-wide
# coder, as in the reference
TRAIT_A = "code_weights holds"


def write_kitti_tree(root, splits=None, points=KITTI_POINTS,
                     n_objects=KITTI_OBJECTS):
    """A raw KITTI tree: training/{velodyne,label_2,calib} and ImageSets
    train / val. Each frame one of bench.py's lidar_ring scenes of
    `points` points with `n_objects` Cars, Pedestrians and Cyclists in
    front of the car (synthetic.SIZE_PRIORS' sizes, within the camera's
    view), labelled in the rect frame through phase 9's calibration, their
    2D boxes the projected corners clipped to the image. Returns the
    frames' point counts."""
    from findnpropagate_torch.datasets.synthetic import (
        SIZE_PRIORS,
        lidar_ring_points,
    )
    from findnpropagate_torch.utils.calibration_kitti import Calibration
    from findnpropagate_torch.utils.geometry_np import boxes_to_corners_3d

    splits = splits or KITTI_SPLITS
    for d in ("velodyne", "label_2", "calib"):
        (root / "training" / d).mkdir(parents=True, exist_ok=True)
    (root / "ImageSets").mkdir(parents=True, exist_ok=True)
    r0 = np.eye(3, dtype=np.float32)
    calib = Calibration({"P2": np.array(KITTI_P2, np.float32), "R0": r0,
                         "Tr_velo2cam": np.array(KITTI_V2C, np.float32)})
    flat = lambda a: " ".join(f"{v:.6g}" for v in np.ravel(a))  # noqa: E731
    counts, start = [], 0
    for split, n in splits.items():
        ids = [f"{start + i:06d}" for i in range(n)]
        start += n
        (root / "ImageSets" / f"{split}.txt").write_text("\n".join(ids)
                                                         + "\n")
        for fid in ids:
            rng = np.random.RandomState(7000 + int(fid))
            names = [KITTI_CLASSES[rng.randint(3)] for _ in range(n_objects)]
            boxes = np.zeros((n_objects, 7), np.float32)
            boxes[:, 0] = rng.uniform(6, 50, n_objects)
            boxes[:, 1] = rng.uniform(-0.6, 0.6, n_objects) * boxes[:, 0]
            for i, nm in enumerate(names):
                mean, std = SIZE_PRIORS[nm]
                boxes[i, 3:6] = np.abs(rng.normal(mean, std))
            boxes[:, 2] = boxes[:, 5] / 2 - SENSOR_H
            boxes[:, 6] = rng.uniform(-np.pi, np.pi, n_objects)
            pts = lidar_ring_points(rng, boxes, points)
            pts.astype(np.float32).tofile(root / "training" / "velodyne"
                                          / f"{fid}.bin")
            counts.append(len(pts))
            (root / "training" / "calib" / f"{fid}.txt").write_text(
                f"P0: {flat(np.zeros(12))}\nP1: {flat(np.zeros(12))}\n"
                f"P2: {flat(KITTI_P2)}\nP3: {flat(np.zeros(12))}\n"
                f"R0_rect: {flat(r0)}\nTr_velo_to_cam: {flat(KITTI_V2C)}\n")
            bottom = boxes[:, :3].copy()
            bottom[:, 2] -= boxes[:, 5] / 2
            loc = calib.lidar_to_rect(bottom)
            corners = calib.lidar_to_img(
                boxes_to_corners_3d(boxes).reshape(-1, 3))[0].reshape(
                n_objects, 8, 2)
            lo = np.clip(corners.min(1), 0, np.array(KITTI_IMAGE) - 1)
            hi = np.clip(corners.max(1), 0, np.array(KITTI_IMAGE) - 1)
            lines = []
            for i, nm in enumerate(names):
                ry = -boxes[i, 6] - np.pi / 2
                ry = (ry + np.pi) % (2 * np.pi) - np.pi
                alpha = ry - np.arctan2(loc[i, 0], loc[i, 2])
                lines.append(
                    f"{nm} 0.00 0 {alpha:.3f} {lo[i, 0]:.2f} {lo[i, 1]:.2f} "
                    f"{hi[i, 0]:.2f} {hi[i, 1]:.2f} {boxes[i, 5]:.3f} "
                    f"{boxes[i, 4]:.3f} {boxes[i, 3]:.3f} {loc[i, 0]:.3f} "
                    f"{loc[i, 1]:.3f} {loc[i, 2]:.3f} {ry:.3f}")
            (root / "training" / "label_2" / f"{fid}.txt").write_text(
                "\n".join(lines) + "\n")
    return counts


def cycled_data(TD, root):
    """The data of a yaml on a dataset tree: its dataset with DATA_PATH
    `root` (build_dataloader, no prefetch) and a batch of n of its samples,
    taken in turn where the split holds fewer; (dataset, batch of numpy
    arrays, the host ms the batch took)."""
    def data(cfg, training, n):
        cfg.DATA_CONFIG.DATA_PATH = str(root)
        ds, _, _ = TD.build_dataloader(
            cfg.DATA_CONFIG, list(cfg.CLASS_NAMES), batch_size=n,
            training=training, seed=0, prefetch=0)
        if not len(ds):
            raise AssertionError(f"{root}: no {('test', 'train')[training]}"
                                 " samples")
        t0 = time.perf_counter()
        batch = ds.collate_batch([ds[i % len(ds)] for i in range(n)])
        ms = (time.perf_counter() - t0) * 1e3
        return ds, {k: v for k, v in batch.items()
                    if isinstance(v, np.ndarray)}, ms
    return data


def on_card(torch, batch, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def forward_decode_ms(torch, det, batch, reps, warm=2):
    """`reps` forwards + post_process after `warm` warm-ups, each split by
    CUDA events into the forward and the decode: (median ms of the whole,
    median ms of the decode, median share of the decode, all wholes)."""
    whole, decode, share = [], [], []
    for i in range(reps + warm):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        out = det(batch)
        ev[1].record()
        det.post_process(out)
        ev[2].record()
        torch.cuda.synchronize()
        del out
        if i >= warm:
            whole.append(ev[0].elapsed_time(ev[2]))
            decode.append(ev[1].elapsed_time(ev[2]))
            share.append(decode[-1] / whole[-1])
    med = lambda v: sorted(v)[len(v) // 2]         # noqa: E731
    return med(whole), med(decode), med(share), whole


def anchor_forwards(torch, det, data, cfg, tp, ws, want, label, batches,
                    dev):
    """Eval forwards + post_process of the yaml at each batch size: the
    launch gate, finite detections, ms/scan, the decode's share, peak
    memory."""
    _, batch, host_ms = data(cfg, False, max(batches))
    out = {"loader_ms": host_ms}
    for b in batches:
        bt = on_card(torch, {k: v[:b] for k, v in batch.items()}, dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _, dets, got = cp_forward(torch, det, bt, tp, ws, want,
                                  f"{label} forward batch {b}")
        med, dec, share, times = forward_decode_ms(torch, det, bt,
                                                   ANCHOR_REPS)
        out[b] = {"launches": got, "ms_per_batch": med, "ms_per_scan": med / b,
                  "times_ms": times, "decode_ms": dec, "decode_share": share,
                  "detections_per_scan": [int(c) for c in dets.count],
                  "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    return out


def matched(torch, det, gt_boxes):
    """Foreground anchors of an anchor head's assignment (ground truths of
    the batch for a CenterHead)."""
    head = det.dense_head
    if hasattr(head, "tools"):
        with torch.no_grad():
            labels = head.tools.assign(gt_boxes)["box_cls_labels"]
        return int((labels > 0).sum())
    return int((gt_boxes[..., -1] > 0).sum())


def anchor_train(torch, mods, cfg, data, label, steps, dev, want=None,
                 record=False):
    """Training at the yaml's batch with its own optimizer (adam_onecycle)
    and clip: one warm-up step (its launches `want`, any where None),
    `steps` timed ones (each with the warm-up's launches), finite loss and
    gradient norm,
    overflow 0, matched anchors > 0, parameters changed; with `record`,
    the K1-K4 calls of one more step. Returns (report, recorded calls)."""
    cfg_mod, models_mod, synth, tp, ws, lap, weights, optimization, \
        trainer = mods
    ds, tbatch, host_ms = data(cfg, True, int(
        cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU))
    det = models_mod.build_network(copy.deepcopy(cfg.MODEL),
                                   len(cfg.CLASS_NAMES), ds, device=dev)
    weights.init_random_(det, seed=0)
    det.train()
    batch = on_card(torch, tbatch, dev)
    n_matched = matched(torch, det, batch["gt_boxes"])
    if n_matched <= 0:
        raise AssertionError(f"{label}: no anchor matched")
    tx, _ = optimization.build_optimizer(det.parameters(), cfg.OPTIMIZATION,
                                         1000)
    step = trainer.make_train_step(det, tx)
    params = [p.detach().clone() for p in det.parameters()]
    warm = cp_step(torch, step, batch, tp, ws, want,
                   f"{label} train warm-up")
    changed = sum(bool((p.detach() != q).any())
                  for p, q in zip(det.parameters(), params))
    if changed < 0.9 * len(params):
        raise AssertionError(f"{label}: only {changed} of {len(params)} "
                             "parameter tensors changed")
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    timed = [cp_step(torch, step, batch, tp, ws, warm["launches"],
                     f"{label} train step") for _ in range(steps)]
    rep = {"batch": len(tbatch["points"]), "loader_ms": host_ms,
           "matched_anchors": n_matched, "warm_up": warm, "steps": timed,
           "ms_per_step": sorted(s["ms"] for s in timed)[len(timed) // 2],
           "losses": [warm["loss"]] + [s["loss"] for s in timed],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "parameters_changed": changed}
    calls = None
    if record:
        with record_positions(torch, tp) as k1, \
                Recorder(tp, "gather_conv", torch) as k2, \
                Recorder(ws, "conv_kernel", torch) as k3, \
                Recorder(ws, "dw_kernel", torch) as k4:
            cp_step(torch, step, batch, tp, ws, warm["launches"],
                    f"{label} recorded step")
        calls = (k1, k2.calls, k3.calls, k4.calls)
    del det, tx, step, batch
    torch.cuda.empty_cache()
    return rep, calls


def kitti_second_posgather(cfg_mod, cfg):
    """second.yaml with SUBM_IMPL: posgather (SUBM_MODE windowed) and the
    main path's windows and block."""
    cfg = copy.deepcopy(cfg)
    main = cfg_mod.cfg_from_yaml_file(str(ROOT / CFG_FILE)).MODEL.BACKBONE_3D
    bb = cfg.MODEL.BACKBONE_3D
    bb.SUBM_MODE, bb.SUBM_IMPL = "windowed", "posgather"
    for key in ("WINDOWED_BLOCK", "WINDOWED_WINDOW",
                "WINDOWED_STRIDED_WINDOW"):
        bb[key] = copy.deepcopy(main[key])
    return cfg


def kitti_run(torch, mods, smi, name, root, dev):
    """One KITTI yaml as written through KittiDataset on the tree at
    `root`: forwards at batch 1 and 4, training steps at batch 4; for
    second.yaml also one step with SUBM_IMPL: posgather, every K1-K4 call
    of it held against its plain version. Returns (report, rows,
    kernels entries)."""
    from findnpropagate_torch import datasets as TD

    cfg_mod, models_mod, synth, tp, ws, lap, weights, optimization, \
        trainer = mods
    cfg = cfg_mod.cfg_from_yaml_file(str(ROOT / ANCHOR_KITTI[name]))
    data = cycled_data(TD, root)
    ds, _, _ = data(cfg, False, 1)
    det = models_mod.build_network(copy.deepcopy(cfg.MODEL),
                                   len(cfg.CLASS_NAMES), ds, device=dev)
    weights.init_random_(det, seed=0)
    rep = {"yaml": ANCHOR_KITTI[name], "device": smi,
           "anchors": int(det.dense_head.tools.anchors.shape[0]),
           "forward": anchor_forwards(torch, det, data, cfg, tp, ws,
                                      NO_LAUNCHES, f"kitti {name}",
                                      ANCHOR_BATCHES, dev)}
    del det
    rep["train"], _ = anchor_train(torch, mods, cfg, data, f"kitti {name}",
                                   ANCHOR_TRAIN_STEPS, dev, NO_LAUNCHES)
    if name != "second":
        return rep, [], []
    pcfg = kitti_second_posgather(cfg_mod, cfg)
    rep["posgather_step"], calls = anchor_train(
        torch, mods, pcfg, data, "kitti second posgather", 1, dev,
        record=True)
    got = rep["posgather_step"]["warm_up"]["launches"]
    if not all(got[k] > 0 for k in NO_LAUNCHES):
        raise AssertionError(f"kitti second posgather step: launches {got}"
                             ", want every K1-K4")
    k1, k2, k3, k4 = calls
    rows = check_positions(torch, tp, k1, "kitti second posgather train ")
    rows += check_train_kernels(torch, tp, ws, k2, k3, k4,
                                k3_forward=len(k3) // 2)
    log_positions_rows([r for r in rows if r["name"] == "positions"],
                       "kitti second posgather ")
    log_conv_rows([r for r in rows if r["name"] != "positions"])
    path = (f"anchor kitti second (SUBM_IMPL posgather) training step "
            f"batch {rep['posgather_step']['batch']}")
    entries = [cp_summary(rows, k, path, got[k]) for k in NO_LAUNCHES]
    return rep, rows, entries


def kitti_phase(torch, mods, smi, dev):
    """Phase 15's KITTI part: the tree (write_kitti_tree), its infos and gt
    database (create_infos kitti --gt_database), pointpillar.yaml and
    second.yaml in process (kitti_run), then train.py (1 epoch) and test.py
    on both as subprocesses, the two chains side by side. Returns (report,
    rows, entries)."""
    from findnpropagate_torch.tools import create_infos

    cfg_mod = mods[0]
    work = ROOT / ANCHOR_WORK / "kitti"
    shutil.rmtree(work, ignore_errors=True)
    root = work / "data"
    t0 = time.perf_counter()
    counts = write_kitti_tree(root)
    create_infos.main(["kitti", "--data_path", str(root), "--gt_database"])
    rep = {"points_per_frame": [min(counts), max(counts)],
           "tree_s": time.perf_counter() - t0}
    with open(root / "kitti_dbinfos_train.pkl", "rb") as f:
        rep["gt_database"] = {k: len(v) for k, v in pickle.load(f).items()}
    if set(rep["gt_database"]) != set(KITTI_CLASSES):
        raise AssertionError(f"kitti gt database: {rep['gt_database']}")
    rows, entries = [], []
    for name in ANCHOR_KITTI:
        rep[name], rw, e = kitti_run(torch, mods, smi, name, root, dev)
        rows, entries = rows + rw, entries + e
        fw, tr = rep[name]["forward"], rep[name]["train"]
        log(f"kitti {name} ({smi}): {ANCHOR_KITTI[name]} as written, "
            f"{rep[name]['anchors']} anchors; " + "; ".join(
                f"batch {b} {fw[b]['ms_per_scan']:.2f} ms/scan, decode "
                f"{fw[b]['decode_ms']:.2f} ms ({100 * fw[b]['decode_share']:.1f}"
                f" % of a forward), detections {fw[b]['detections_per_scan']}"
                f", peak {fw[b]['peak_mem_gb']:.2f} GiB"
                for b in ANCHOR_BATCHES)
            + f"; training batch {tr['batch']} {tr['ms_per_step']:.1f} "
            f"ms/step, losses {[round(v, 3) for v in tr['losses']]}, "
            f"{tr['matched_anchors']} anchors matched, peak "
            f"{tr['peak_mem_gb']:.2f} GiB; loader host ms {fw['loader_ms']:.1f}"
            f" (eval batch {max(ANCHOR_BATCHES)}), {tr['loader_ms']:.1f} "
            "(training batch)")
    ps = rep["second"]["posgather_step"]
    log(f"kitti second SUBM_IMPL posgather ({smi}): warm-up step "
        f"{ps['warm_up']['ms']:.1f} ms, step {ps['ms_per_step']:.1f} ms, "
        f"launches {ps['warm_up']['launches']}, losses "
        f"{[round(v, 3) for v in ps['losses']]}")
    clis = kitti_clis(cfg_mod, smi, work, {
        f"kitti {name}": ANCHOR_KITTI[name] for name in ANCHOR_KITTI})
    for name in ANCHOR_KITTI:
        rep[name]["cli"] = clis[f"kitti {name}"]
    return rep, rows, entries


def lyft_phase(torch, mods, smi, dev, root):
    """cbgs_second_multihead.yaml through LyftDataset on phase 14's tree:
    a batch-4 forward as written (its overflow, actives per level beside
    LEVEL_CAPACITIES), then with every level's windows at least the main
    path's a batch-4 forward whose K1 / K2 calls are held against their
    plain versions, and a training step, which raises trait (a)'s error.
    Returns (report, rows, entries)."""
    from findnpropagate_torch import datasets as TD

    cfg_mod, models_mod, synth, tp, ws, lap, weights, optimization, \
        trainer = mods
    cfg = cfg_mod.cfg_from_yaml_file(str(ROOT / ANCHOR_LYFT))
    data = cycled_data(TD, root)
    ds, batch, host_ms = data(cfg, False, max(ANCHOR_BATCHES))
    b4 = on_card(torch, batch, dev)
    n_class = len(cfg.CLASS_NAMES)
    det = models_mod.build_network(copy.deepcopy(cfg.MODEL), n_class, ds,
                                   device=dev)
    weights.init_random_(det, seed=0)
    with torch.no_grad(), overflow_sites(torch, ws) as sites:
        out = det(b4)
        dets = det.post_process(out)
    if not bool(torch.isfinite(dets.boxes).all()):
        raise AssertionError("lyft as written: non-finite boxes")
    rep = {"yaml": ANCHOR_LYFT, "device": smi, "loader_ms": host_ms,
           "points_per_scan": [int(v) for v in b4["points_mask"].sum(1)],
           "as_written": {"overflow": int(out["sparse_window_overflow"]),
                          "dropped_at": dropped(sites),
                          "windows": cp_widen(cfg_mod, cfg, 3, 1)},
           "actives": cp_actives(torch, det, b4, len(batch["points"]))}
    del det, out, dets
    det = models_mod.build_network(copy.deepcopy(cfg.MODEL), n_class, ds,
                                   device=dev)
    weights.init_random_(det, seed=0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with record_positions(torch, tp) as k1, \
            Recorder(tp, "gather_conv", torch) as k2:
        _, dets, got = cp_forward(torch, det, b4, tp, ws, EVAL_LAUNCHES,
                                  "lyft forward batch 4")
    med, dec, share, _ = forward_decode_ms(torch, det, b4, ANCHOR_REPS)
    rep["forward"] = {"launches": got, "ms_per_scan": med / len(
        batch["points"]), "decode_ms": dec, "decode_share": share,
        "detections_per_scan": [int(c) for c in dets.count],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    rows = check_positions(torch, tp, k1, "lyft forward ")
    rows += check_kernels(torch, tp, [], k2.calls)
    log_positions_rows([r for r in rows if r["name"] == "positions"],
                       "lyft ")
    log_conv_rows([r for r in rows if r["name"] != "positions"])
    path = "anchor lyft cbgs_second_multihead forward batch 4"
    entries = [cp_summary(rows, k, path, got[k])
               for k in ("positions", "posgather_conv")]
    # trait (a): a training step raises. Phase 14's tree names its objects
    # with nuScenes' general names ("vehicle.car"), none of the yaml's
    # classes, and the training loader resamples a frame without a ground
    # truth until it finds one: the step takes the eval batch, as the error
    # comes before the assignment reads a box
    tx, _ = optimization.build_optimizer(det.parameters(), cfg.OPTIMIZATION,
                                         1000)
    try:
        trainer.make_train_step(det, tx)(b4)
    except ValueError as e:
        if TRAIT_A not in str(e):
            raise
        rep["train_raises"] = str(e)
    else:
        raise AssertionError("lyft: a training step did not raise trait "
                             "(a)'s error")
    del det, tx
    torch.cuda.empty_cache()
    act = rep["actives"]
    log(f"lyft ({smi}): {ANCHOR_LYFT} as written, points per scan "
        f"{rep['points_per_scan']}: {rep['as_written']['overflow']} "
        f"neighbour spans dropped in a batch-4 forward ([kind, window, "
        f"targets, counter, real]: {rep['as_written']['dropped_at']}); "
        f"windows (as written, gated forward) "
        f"{rep['as_written']['windows']}; actives per level and scene "
        f"{act['per_scene']} against caps {act['caps']} (LEVEL_CAPACITIES "
        f"{act['level_capacities']}); levels at their cap: "
        f"{act['at_cap'] or 'none'}; gated forward "
        f"{rep['forward']['ms_per_scan']:.2f} ms/scan at batch 4, decode "
        f"{rep['forward']['decode_ms']:.2f} ms "
        f"({100 * rep['forward']['decode_share']:.1f} %), launches {got}, peak "
        f"{rep['forward']['peak_mem_gb']:.2f} GiB; a training step raises: "
        f"{rep['train_raises']}")
    return rep, rows, entries


def plain_yaml_run(torch, mods, smi, yaml, root, dev, train, label):
    """A yaml whose path launches none of K1-K4 on a dataset tree: a
    batch-4 forward + post_process (timed, the decode's share, peak
    memory) and, with `train`, a warm-up and one timed training step."""
    from findnpropagate_torch import datasets as TD

    cfg_mod, models_mod, *_, weights, _, _ = mods
    cfg = cfg_mod.cfg_from_yaml_file(str(ROOT / yaml))
    data = cycled_data(TD, root)
    ds, _, _ = data(cfg, False, 1)
    det = models_mod.build_network(copy.deepcopy(cfg.MODEL),
                                   len(cfg.CLASS_NAMES), ds, device=dev)
    weights.init_random_(det, seed=0)
    rep = {"yaml": yaml, "device": smi, "forward": anchor_forwards(
        torch, det, data, cfg, mods[3], mods[4], NO_LAUNCHES, label,
        (max(ANCHOR_BATCHES),), dev)}
    del det
    if train:
        rep["train"], _ = anchor_train(torch, mods, cfg, data, label, 1,
                                       dev, NO_LAUNCHES)
    fw = rep["forward"][max(ANCHOR_BATCHES)]
    tr = rep.get("train")
    log(f"{label} ({smi}): {yaml} as written, batch "
        f"{max(ANCHOR_BATCHES)} {fw['ms_per_scan']:.2f} ms/scan, decode "
        f"{fw['decode_ms']:.2f} ms ({100 * fw['decode_share']:.1f} %), "
        f"detections {fw['detections_per_scan']}, peak "
        f"{fw['peak_mem_gb']:.2f} GiB" + (
            f"; training batch {tr['batch']} {tr['ms_per_step']:.1f} "
            f"ms/step (warm-up {tr['warm_up']['ms']:.1f}), losses "
            f"{[round(v, 3) for v in tr['losses']]}, {tr['matched_anchors']}"
            f" matched, peak {tr['peak_mem_gb']:.2f} GiB" if tr else ""))
    return rep


def anchor_phase(torch, mods, smi, dev="cuda"):
    """Phase 15: the anchor heads and pillar VFEs on the yamls as written
    (KITTI tree of its own; Lyft and Waymo on phase 14's trees, nuScenes
    on phase 12's). Returns (report, rows, kernels entries)."""
    t0 = time.perf_counter()
    rep = {"device": smi}
    rep["kitti"], rows, entries = kitti_phase(torch, mods, smi, dev)
    rep["lyft"], rw, e = lyft_phase(torch, mods, smi, dev,
                                    ROOT / MISC_WORK / "lyft" / "trainval")
    rows, entries = rows + rw, entries + e
    for name, (yaml, train) in ANCHOR_NUS.items():
        rep[name] = plain_yaml_run(torch, mods, smi, yaml,
                                   ROOT / PAPER_WORK / "nuscenes", dev, train,
                                   f"nuscenes {name}")
    rep["waymo_pointpillar_1x"] = plain_yaml_run(
        torch, mods, smi, ANCHOR_WAYMO, ROOT / WAYMO_WORK / "data", dev,
        True, "waymo pointpillar_1x")
    rep["phase_s"] = time.perf_counter() - t0
    log(f"anchor phase: {rep['phase_s']:.1f} s")
    return rep, rows, entries


# ---- phase 16: VoxelNeXt, VoxelNeXt2D, PillarNet, TransFusionHeadAM

# label: (yaml, data tree, batches of the kernels' mode, a training step,
# a posgather-mode forward). Trees: phase 12's nuScenes, phase 14's Waymo,
# phase 15's KITTI; "ring": bench.py's lidar_ring scenes in the yaml's
# range and voxel size (Argo2's infos need pandas, which the card's
# machine lacks; the AM head on the main path's data)
VN_RUNS = {
    "nus voxelnext 0075": (
        "tools/cfgs/nuscenes_models/cbgs_voxel0075_voxelnext.yaml",
        "nuscenes", (1, 4), True, True),
    "nus voxelnext": ("tools/cfgs/nuscenes_models/voxelnext.yaml",
                      "nuscenes", (4,), False, True),
    "nus voxelnext doubleflip": (
        "tools/cfgs/nuscenes_models/cbgs_voxel0075_voxelnext_doubleflip.yaml",
        "nuscenes", (4,), False, False),
    "argo2 voxelnext": ("tools/cfgs/argo2_models/cbgs_voxel01_voxelnext.yaml",
                        "ring", (4,), False, False),
    "waymo voxelnext large": (
        "tools/cfgs/waymo_models/voxelnext_ioubranch_large.yaml", "waymo",
        (1, 4), True, True),
    "waymo voxelnext2d": ("tools/cfgs/waymo_models/voxelnext2d_ioubranch.yaml",
                          "waymo", (4,), True, False),
    "waymo pillarnet": ("tools/cfgs/waymo_models/pillarnet.yaml", "waymo",
                        (4,), True, False),
    "nus pillarnet": (
        "tools/cfgs/nuscenes_models/cbgs_pillar0075_res2d_centerpoint.yaml",
        "nuscenes", (4,), True, False),
    "kitti pillarnet": ("tools/cfgs/kitti_models/pillarnet.yaml", "kitti",
                        (), True, False),
    "transfusion AM": (CFG_FILE, "ring", (1, 4), True, False),
}
VN_BATCH = 4                  # the as-written forward and the steps
VN_BLOCK = 512                # the kernels' modes: blocks of 512 ids
VN_TREES = {"nuscenes": ROOT / PAPER_WORK / "nuscenes",
            "waymo": ROOT / WAYMO_WORK / "data",
            "kitti": KITTI_TREE}


def vn_cfg(cfg_mod, label, impl=None):
    """The run's yaml as written, or in SUBM_IMPL `impl` with the kernels'
    block (the reference's Pallas path asserts block % 512 == 0, so the
    head's block follows: it must divide the BEV list) and every level's
    windows at least the main path's (cp_widen). The AM run is
    transfusion_lidar.yaml with TransFusionHeadAM, whose own mode is the
    main path's posgather."""
    cfg = cfg_mod.cfg_from_yaml_file(str(ROOT / VN_RUNS[label][0]))
    cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU = VN_BATCH
    if label == "transfusion AM":
        cfg.MODEL.DENSE_HEAD.NAME = "TransFusionHeadAM"
        return cfg
    if impl is not None:
        bb = cfg.MODEL.BACKBONE_3D
        bb.SUBM_IMPL = impl
        bb.WINDOWED_BLOCK = VN_BLOCK
        if "WINDOWED_BLOCK" in cfg.MODEL.DENSE_HEAD:
            cfg.MODEL.DENSE_HEAD.WINDOWED_BLOCK = VN_BLOCK
        bb.setdefault("WINDOWED_STRIDED_WINDOW", 4 * int(
            bb.get("WINDOWED_WINDOW", 1024)))
        cp_widen(cfg_mod, cfg, 3, 1)
    return cfg


def vn_data(cfg_mod, synth, tree):
    """data(cfg, training, n) of a run's tree."""
    from findnpropagate_torch import datasets as TD

    if tree == "ring":
        return synthetic_data(cfg_mod, synth)
    return cycled_data(TD, VN_TREES[tree])


def hold_calls(torch, tp, ws, k1, k2, k3, k4, label):
    """Every recorded K1-K4 call of a run against its plain version on the
    card: K1 bit for bit in its five fields (check_level), K2 / K3 / K4
    within K2_RTOL / K3_RTOL / K4_RTOL of the output's scale (K4 also the
    same bits twice), each call timed once after its first run and its
    plain version once, with its bound, and K1's library call (k1_library:
    torch.searchsorted, its ranks checked) once. Returns per-call rows."""
    rows = []
    cat = lambda outs: torch.cat(outs, dim=0)          # noqa: E731
    for i, (args, kw) in enumerate(k1):
        _, ref, given = check_level(torch, tp, args, kw,
                                    f"{label} K1 call {i}")
        bound_ms, bound_by = bound_entry(*positions_bound(ref, args[1],
                                                          given[7]))
        rows.append({"name": "positions", "call": i, "max_abs_err": 0.0,
                     "ms": timing.ms(lambda: tp.compute_positions(
                         *args, **kw), 1),
                     "plain_ms": timing.ms(lambda: tp.compute_positions_plain(
                         *args, **kw), 1, warm=0),
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": timing.ms(k1_library(
                         torch, given[0], given[1], ref), 1)})
    for i, (args, kw) in enumerate(k2):
        out = tp.gather_conv(*args, **kw)
        plain = lambda: per_sample(                     # noqa: E731
            tp.posgather_conv_plain, args, kw, (0, 1, 2, 3, 4, 5), cat)
        err, tol = k2_err(torch, out, plain(), f"{label} K2 call {i}")
        t_b, t_o, hits = conv_bound(tp, args, kw)
        bound_ms, bound_by = bound_entry(t_b, t_o)
        rows.append({"name": "posgather_conv", "call": i,
                     "cin": args[1].shape[2], "cout": args[7].shape[1],
                     "hits": hits, "max_abs_err": err, "tolerance": tol,
                     "ms": timing.ms(lambda: tp.gather_conv(*args, **kw), 1),
                     "plain_ms": timing.ms(plain, 1, warm=0),
                     "bound_ms": bound_ms, "bound_by": bound_by})
    for i, (args, kw) in enumerate(k3):
        src, feats, tgt, lo, deltas, w_flat, block, window = args
        out = ws.conv_kernel(*args, **kw)
        plain = lambda: per_sample(                     # noqa: E731
            ws.windowed_conv_plain, args, plain_kw(kw), (0, 1, 2, 3), cat)
        err, tol = k3_err(torch, out, plain(), f"{label} K3 call {i}")
        hits = windowed_hits(torch, ws, src, tgt, lo, deltas, block, window)
        cin, cout = feats.shape[2], w_flat.shape[1]
        nbytes = (4 * (src.numel() + tgt.numel() + lo.numel()
                       + deltas.numel() + feats.numel())
                  + 2 * w_flat.numel() + 4 * tgt.numel() * cout)
        bound_ms, bound_by = bound_entry(nbytes / HBM_BYTES_PER_S,
                                         2 * cin * cout * hits / BF16_FLOPS)
        rows.append({"name": "windowed_conv", "call": i, "cin": cin,
                     "cout": cout, "taps": int(deltas.shape[0]),
                     "epilogue": kw.get("scale") is not None, "hits": hits,
                     "max_abs_err": err, "tolerance": tol,
                     "ms": timing.ms(lambda: ws.conv_kernel(*args, **kw), 1),
                     "plain_ms": timing.ms(plain, 1, warm=0),
                     "bound_ms": bound_ms, "bound_by": bound_by})
    for i, (args, kw) in enumerate(k4):
        src, feats, tgt, g, lo, deltas, block, window = args
        out = ws.dw_kernel(*args, **kw)
        plain = lambda: per_sample(                     # noqa: E731
            ws.windowed_dw_plain, args,
            {"compute_dtype": kw["compute_dtype"]}, (0, 1, 2, 3, 4),
            lambda outs: torch.stack(outs).sum(dim=0))
        ref = plain()
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        tol = K4_RTOL * max(float(ref.abs().max()), 1e-3)
        if not (err <= tol and bool(torch.isfinite(out).all())
                and torch.equal(out, ws.dw_kernel(*args, **kw))):
            raise AssertionError(f"{label} K4 call {i}: err {err} > {tol} "
                                 "or two runs differ")
        hits = windowed_hits(torch, ws, src, tgt, lo, deltas, block, window)
        cin, cout = feats.shape[2], g.shape[2]
        nbytes = 4 * (src.numel() + tgt.numel() + lo.numel() + feats.numel()
                      + g.numel() + deltas.numel() * (1 + cin * cout))
        bound_ms, bound_by = bound_entry(nbytes / HBM_BYTES_PER_S,
                                         2 * cin * cout * hits / BF16_FLOPS)
        rows.append({"name": "windowed_dw", "call": i, "cin": cin,
                     "cout": cout, "taps": int(deltas.shape[0]),
                     "hits": hits, "max_abs_err": err, "tolerance": tol,
                     "ms": timing.ms(lambda: ws.dw_kernel(*args, **kw), 1),
                     "plain_ms": timing.ms(plain, 1, warm=0),
                     "bound_ms": bound_ms, "bound_by": bound_by})
    return rows


@contextlib.contextmanager
def record_kernels(torch, tp, ws):
    """The K1-K4 calls made inside, in call order."""
    with record_positions(torch, tp) as k1, \
            Recorder(tp, "gather_conv", torch) as k2, \
            Recorder(ws, "conv_kernel", torch) as k3, \
            Recorder(ws, "dw_kernel", torch) as k4:
        yield k1, k2.calls, k3.calls, k4.calls


def vn_gate(label, got, need):
    """Each kernel in `need` launched, none other."""
    bad = {k: v for k, v in got.items() if (v > 0) != (k in need)}
    if bad:
        raise AssertionError(f"{label}: launches {got}, want {need} only")


def vn_entries(rows, path, launches):
    return [cp_summary(rows, k, path, launches[k]) for k in launches
            if launches[k] and any(r["name"] == k for r in rows)]


def vn_forwards(torch, mods, cfg, data, label, batches, need, dev,
                reps=ANCHOR_REPS, warm=2, calls_want=None):
    """Eval forwards + post_process at each batch size with the launch
    gate (`need`: the kernels the mode launches; `calls_want`: each
    kernel's calls a forward, pa_calls_gate), the batch-4 forward's
    calls recorded and held against plain; `reps` timed forwards after
    `warm` more (none with reps 0). Returns (report, rows, entries)."""
    cfg_mod, models_mod, synth, tp, ws, lap, weights, *_ = mods
    ds, batch, host_ms = data(cfg, False, max(batches))
    det = models_mod.build_network(copy.deepcopy(cfg.MODEL),
                                   len(cfg.CLASS_NAMES), ds, device=dev)
    weights.init_random_(det, seed=0)
    rep, rows, entries = {"loader_ms": host_ms}, [], []
    for b in batches:
        bt = on_card(torch, {k: v[:b] for k, v in batch.items()}, dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with record_kernels(torch, tp, ws) as calls:
            out, dets, got = cp_forward(torch, det, bt, tp, ws, None,
                                        f"{label} forward batch {b}")
        vn_gate(f"{label} forward batch {b}", got, need)
        if calls_want is not None:
            pa_calls_gate(f"{label} forward batch {b}", calls, calls_want)
        rep[b] = {"launches": got,
                  "overflow": int(out.get("sparse_window_overflow", 0)),
                  "detections_per_scan": [int(c) for c in dets.count]}
        # the gated forward's outputs go before the timed ones are made
        del out, dets
        if reps:
            med, dec, share, times = forward_decode_ms(torch, det, bt, reps,
                                                       warm)
            rep[b].update(ms_per_scan=med / b, times_ms=times, decode_ms=dec,
                          decode_share=share)
        rep[b]["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        if b == max(batches) and need:
            rows = hold_calls(torch, tp, ws, *calls, f"{label} forward")
            entries = vn_entries(rows, f"{label} forward batch {b}", got)
        del calls
    del det
    torch.cuda.empty_cache()
    return rep, rows, entries


def vn_step(torch, mods, cfg, data, label, need, dev):
    """One warm-up and one timed training step at VN_BATCH with the yaml's
    optimizer and clip (anchor_train's gates: finite loss and gradient
    norm, overflow 0, parameters changed), the timed step's calls recorded
    and held against plain. Returns (report, rows, entries)."""
    with record_kernels(torch, mods[3], mods[4]) as calls:
        rep, _ = anchor_train(torch, mods, cfg, data, label, 1, dev)
    got = rep["steps"][0]["launches"]
    vn_gate(f"{label} step", got, need)
    # the warm-up's calls, then the timed step's: hold the timed step's
    calls = [c[len(c) // 2:] for c in calls]
    rows = hold_calls(torch, mods[3], mods[4], *calls, f"{label} step")
    del calls
    return rep, rows, vn_entries(rows, f"{label} training step batch "
                                 f"{rep['batch']}", got)


def vn_run(torch, mods, smi, label, dev):
    """One run of VN_RUNS: the yaml as written (a batch-4 forward, its
    overflow printed), then its kernels' mode (pallas; the AM head on the
    main path's posgather backbone) at its batches and its training step,
    and a posgather-mode forward where the reference routes the 3x3x3
    strided convs to K1 / K2. Returns (report, rows, entries)."""
    cfg_mod, models_mod, synth, tp, ws, *_ = mods
    yaml, tree, batches, step, posgather = VN_RUNS[label]
    data = vn_data(cfg_mod, synth, tree)
    rep = {"yaml": yaml, "device": smi}
    rows, entries = [], []
    am = label == "transfusion AM"
    if not am and batches:
        cfg = vn_cfg(cfg_mod, label)
        rep["as_written"], _, _ = vn_forwards(
            torch, mods, cfg, data, f"{label} as written", (VN_BATCH,), (),
            dev)
    kcfg = vn_cfg(cfg_mod, label, None if am else "pallas")
    # the AM head's posgather backbone: K1, K2 at eval, K1-K4 in training
    need = ("positions", "posgather_conv") if am else ("windowed_conv",)
    if batches:
        rep["kernels_mode"], rw, e = vn_forwards(torch, mods, kcfg, data,
                                                 label, batches, need, dev)
        rows, entries = rows + rw, entries + e
    if step:
        rep["step"], rw, e = vn_step(
            torch, mods, kcfg, data, label, ("windowed_conv", "windowed_dw")
            + (("positions", "posgather_conv") if am else ()), dev)
        rows, entries = rows + rw, entries + e
    if posgather:
        pcfg = vn_cfg(cfg_mod, label, "posgather")
        rep["posgather"], rw, e = vn_forwards(
            torch, mods, pcfg, data, f"{label} posgather", (VN_BATCH,),
            ("positions", "posgather_conv", "windowed_conv"), dev)
        rows, entries = rows + rw, entries + e
    parts = [f"{label} ({smi}): {yaml}"]
    if "as_written" in rep:
        aw = rep["as_written"][VN_BATCH]
        parts.append(f"as written batch {VN_BATCH} {aw['ms_per_scan']:.2f} "
                     f"ms/scan, overflow {aw['overflow']}")
    for key, name in (("kernels_mode", "AM (posgather)" if am else "pallas"),
                      ("posgather", "posgather")):
        for b, r in rep.get(key, {}).items():
            if b == "loader_ms":
                continue
            parts.append(
                f"{name} batch {b} {r['ms_per_scan']:.2f} ms/scan, decode "
                f"{100 * r['decode_share']:.1f} %, launches {r['launches']}, "
                f"detections {r['detections_per_scan']}, peak "
                f"{r['peak_mem_gb']:.2f} GiB")
    if "step" in rep:
        st = rep["step"]
        parts.append(f"step batch {st['batch']} {st['ms_per_step']:.1f} ms "
                     f"(warm-up {st['warm_up']['ms']:.1f}), launches "
                     f"{st['steps'][0]['launches']}, losses "
                     f"{[round(v, 3) for v in st['losses']]}, peak "
                     f"{st['peak_mem_gb']:.2f} GiB")
    worst = {}
    for r in rows:
        worst[r["name"]] = max(worst.get(r["name"], 0.0),
                               r["max_abs_err"] / max(r.get("tolerance", 1),
                                                      1e-30))
    parts.append(f"{len(rows)} recorded calls against plain, worst "
                 f"err / tolerance {worst}")
    log("; ".join(parts))
    return rep, rows, entries


def voxelnext_phase(torch, mods, smi, dev="cuda"):
    """Phase 16: VN_RUNS in turn (the KITTI PillarNet yaml's train.py /
    test.py run in phase 18, kitti_clis). Returns (report, rows,
    entries)."""
    t0 = time.perf_counter()
    rep, rows, entries = {"device": smi}, [], []
    for label in VN_RUNS:
        rep[label], rw, e = vn_run(torch, mods, smi, label, dev)
        rows, entries = rows + rw, entries + e
    rep["phase_s"] = time.perf_counter() - t0
    log(f"phase 16 ({smi}): {rep['phase_s']:.1f} s, {len(rows)} kernel "
        "calls held against plain")
    return rep, rows, entries


# ---- phase 17: the voxel two-stage detectors

# label: (yaml, tree, a training step, a representative: timed forwards
# and ts_probe; the others' forwards are gated only). Trees: phase 15's
# KITTI, phase 14's Waymo, ONCE and Custom
TS_RUNS = {
    "kitti second_iou": ("tools/cfgs/kitti_models/second_iou.yaml", "kitti",
                         True, False),
    "kitti voxel_rcnn_car": ("tools/cfgs/kitti_models/voxel_rcnn_car.yaml",
                             "kitti", True, True),
    "kitti pv_rcnn": ("tools/cfgs/kitti_models/pv_rcnn.yaml", "kitti", True,
                      False),
    "waymo pv_rcnn": ("tools/cfgs/waymo_models/pv_rcnn.yaml", "waymo",
                      False, False),
    "waymo pv_rcnn_plusplus": (
        "tools/cfgs/waymo_models/pv_rcnn_plusplus.yaml", "waymo", True,
        True),
    "waymo pv_rcnn_plusplus_resnet": (
        "tools/cfgs/waymo_models/pv_rcnn_plusplus_resnet.yaml", "waymo",
        False, False),
    "waymo pv_rcnn_plusplus_resnet_2frames": (
        "tools/cfgs/waymo_models/pv_rcnn_plusplus_resnet_2frames.yaml",
        "waymo", False, False),
    "waymo pv_rcnn_with_centerhead_rpn": (
        "tools/cfgs/waymo_models/pv_rcnn_with_centerhead_rpn.yaml", "waymo",
        False, False),
    "waymo voxel_rcnn_with_centerhead_dyn_voxel": (
        "tools/cfgs/waymo_models/voxel_rcnn_with_centerhead_dyn_voxel.yaml",
        "waymo", False, False),
    "once pv_rcnn": ("tools/cfgs/once_models/pv_rcnn.yaml", "once", False,
                     False),
    "custom pv_rcnn": ("tools/cfgs/custom_models/pv_rcnn.yaml", "custom",
                       False, False),
}
TS_TREES = {"kitti": KITTI_TREE,
            "waymo": ROOT / WAYMO_WORK / "data",
            "once": ROOT / ONCE_WORK / "data",
            "custom": ROOT / MISC_WORK / "custom"}
TS_BATCH = 4                  # the forwards' largest batch and the steps'
TS_BLOCK = 512                # posgather mode: blocks of 512 ids
# the main path's windows times this factor (the 2-frame stack holds twice
# the points, as phase 14's 4-frame run widened its own)
TS_WIDEN = {"waymo pv_rcnn_plusplus_resnet_2frames": 2}
TS_CLI = "tools/cfgs/kitti_models/voxel_rcnn_car.yaml"
TS_EVAL = ("positions", "posgather_conv")
TS_TRAIN = ("positions", "posgather_conv", "windowed_conv", "windowed_dw")


def ts_cfg(cfg_mod, label, posgather=False):
    """The run's yaml as written (BATCH_SIZE_PER_GPU TS_BATCH), or with
    SUBM_IMPL posgather (SUBM_MODE windowed), blocks of TS_BLOCK and every
    level's windows the main path's (times TS_WIDEN)."""
    cfg = cfg_mod.cfg_from_yaml_file(str(ROOT / TS_RUNS[label][0]))
    cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU = TS_BATCH
    if posgather:
        main = cfg_mod.cfg_from_yaml_file(
            str(ROOT / CFG_FILE)).MODEL.BACKBONE_3D
        bb = cfg.MODEL.BACKBONE_3D
        bb.SUBM_MODE, bb.SUBM_IMPL = "windowed", "posgather"
        bb.WINDOWED_BLOCK = TS_BLOCK
        f = TS_WIDEN.get(label, 1)
        for key in CP_WIDEN:
            bb[key] = [f * int(v) for v in main[key]]
    return cfg


def ts_probe(torch, mods, cfg, data, label, dev, extra=None):
    """One training-mode forward (no gradient) of a representative: the
    ROI sampler's fg / bg / interval counts, and on the first stage's
    outputs of that forward the proposal layer's ms (TRAIN and TEST
    NMS_CONFIG, both through the greedy NMS on the host) and, with a PFE,
    its keypoint sampling's ms (FPS, or PV-RCNN++'s sector FPS); `extra`
    (torch, det, out, batch) -> more timings on that forward's tensors."""
    from findnpropagate_torch.models.roi_heads.roi_head_template import (
        proposal_layer,
    )

    cfg_mod, models_mod, synth, tp, ws, lap, weights, *_ = mods
    ds, tbatch, _ = data(cfg, True, TS_BATCH)
    det = models_mod.build_network(copy.deepcopy(cfg.MODEL),
                                   len(cfg.CLASS_NAMES), ds, device=dev)
    weights.init_random_(det, seed=0)
    det.train()
    cap = {}
    stage = det.roi_proposal if det.roi_proposal is not None \
        else det.roi_head
    hooks = [stage.register_forward_pre_hook(
        lambda m, a: cap.setdefault("roi", dict(a[0])))]
    if det.pfe is not None:
        hooks.append(det.pfe.register_forward_pre_hook(
            lambda m, a: cap.setdefault("pfe", dict(a[0]))))
    batch = on_card(torch, tbatch, dev)
    with torch.no_grad():
        out = det(batch)
    for h in hooks:
        h.remove()
    t = out["rcnn_targets"]
    labels = t["rcnn_cls_labels"]
    rep = {"fg": [int(v) for v in t["reg_valid_mask"].sum(1)],
           "bg": [int(v) for v in (labels == 0).sum(1)],
           "interval": [int(v) for v in ((labels > 0) & (labels < 1)).sum(1)],
           "candidates": int(cap["roi"]["batch_box_preds"].shape[1])}
    nms = det.roi_head.model_cfg["NMS_CONFIG"]
    # one call each, no warm-up: the forward ran the same operations
    with torch.no_grad():
        for mode in ("TRAIN", "TEST"):
            rep[f"proposal_{mode.lower()}_ms"] = timing.ms(
                lambda: proposal_layer(cap["roi"]["batch_cls_preds"],
                                       cap["roi"]["batch_box_preds"],
                                       nms[mode]), 1, warm=0)
            rep[f"proposal_{mode.lower()}_pre"] = min(
                int(nms[mode]["NMS_PRE_MAXSIZE"]), rep["candidates"])
        if det.pfe is not None:
            rep["keypoints"] = int(det.pfe.model_cfg["NUM_KEYPOINTS"])
            rep["sampling"] = str(det.pfe.model_cfg.get("SAMPLE_METHOD",
                                                        "FPS"))
            rep["fps_ms"] = timing.ms(lambda: det.pfe.keypoints(cap["pfe"]),
                                      1, warm=0)
        if extra is not None:
            rep.update(extra(torch, det, out, batch))
    del det, out, cap, batch
    torch.cuda.empty_cache()
    return rep


def timed_text(r):
    """A forward report's ms/scan and decode share, where it was timed."""
    if "ms_per_scan" not in r:
        return "not timed"
    return (f"{r['ms_per_scan']:.2f} ms/scan, decode "
            f"{100 * r['decode_share']:.1f} %")


def ts_log(label, smi, rep, rows):
    """Logs a run of TS_RUNS or PA_RUNS: its forwards, its training step
    with the probe's counts and timings, and the worst of its calls held
    against plain."""
    parts = [f"{label} ({smi}): {rep['yaml']}"]
    for key in ("as_written", "posgather"):
        for b, r in rep.get(key, {}).items():
            if b == "loader_ms":
                continue
            parts.append(
                f"{key.replace('_', ' ')} batch {b} {timed_text(r)}, "
                f"launches {r['launches']}, overflow {r['overflow']}, "
                f"detections {r['detections_per_scan']}, peak "
                f"{r['peak_mem_gb']:.2f} GiB")
    if "step" in rep:
        st = rep["step"]
        parts.append(
            f"step batch {st['batch']} {st['ms_per_step']:.1f} ms (warm-up "
            f"{st['warm_up']['ms']:.1f}), launches "
            f"{st['steps'][0]['launches']}, losses "
            f"{[round(v, 3) for v in st['losses']]}, peak "
            f"{st['peak_mem_gb']:.2f} GiB")
    if "probe" in rep:
        pr = rep["probe"]
        text = (f"ROI sampler fg {pr['fg']} bg {pr['bg']} interval "
                f"{pr['interval']}; proposal layer over {pr['candidates']} "
                f"boxes: TRAIN (pre {pr['proposal_train_pre']}) "
                f"{pr['proposal_train_ms']:.1f} ms, TEST (pre "
                f"{pr['proposal_test_pre']}) {pr['proposal_test_ms']:.1f} ms")
        if "fps_ms" in pr:
            text += (f"; {pr['sampling']} of {pr['keypoints']} points "
                     f"{pr['fps_ms']:.1f} ms")
        if "roiaware_avg_ms" in pr:
            text += (f"; ROI-aware pooling of {pr['rois']} ROIs over "
                     f"{pr['points']} voxels avg {pr['roiaware_avg_ms']:.1f}"
                     f" / max {pr['roiaware_max_ms']:.1f} ms")
        if "roipoint_ms" in pr:
            text += (f"; ROI point pooling of {pr['rois']} ROIs over "
                     f"{pr['points']} points {pr['roipoint_ms']:.1f} ms")
        parts.append(text)
    worst = {}
    for r in rows:
        worst[r["name"]] = max(worst.get(r["name"], 0.0),
                               r["max_abs_err"] / max(r.get("tolerance", 1),
                                                      1e-30))
    parts.append(f"{len(rows)} recorded calls against plain, worst "
                 f"err / tolerance {worst}")
    log("; ".join(parts))


def ts_run(torch, mods, smi, label, dev):
    """One run of TS_RUNS: the yaml as written (a gated batch-4 forward, no
    K1-K4 launch, overflow 0), its posgather forwards at batch 1 and 4 (K1
    and K2 only, overflow 0, the batch-4 calls held against plain), with
    a training step a warm-up and a timed step at batch 4 (every K1-K4
    launched, the timed step's calls held against plain), and for a
    representative each gated forward followed by a timed one and
    ts_probe. Returns (report, rows, entries)."""
    from findnpropagate_torch import datasets as TD

    cfg_mod = mods[0]
    yaml, tree, train, timed = TS_RUNS[label]
    data = cycled_data(TD, TS_TREES[tree])
    rep = {"yaml": yaml, "device": smi}
    reps = 1 if timed else 0
    rep["as_written"], _, _ = vn_forwards(
        torch, mods, ts_cfg(cfg_mod, label), data, f"{label} as written",
        (TS_BATCH,), (), dev, reps=reps, warm=0)
    pcfg = ts_cfg(cfg_mod, label, posgather=True)
    rep["posgather"], rows, entries = vn_forwards(
        torch, mods, pcfg, data, f"{label} posgather", (1, TS_BATCH),
        TS_EVAL, dev, reps=reps, warm=0)
    if train:
        rep["step"], rw, e = vn_step(torch, mods, pcfg, data, label,
                                     TS_TRAIN, dev)
        rows, entries = rows + rw, entries + e
    if timed:
        rep["probe"] = ts_probe(torch, mods, pcfg, data, label, dev)
    ts_log(label, smi, rep, rows)
    return rep, rows, entries


def two_stage_phase(torch, mods, smi, dev="cuda"):
    """Phase 17: TS_RUNS in turn (its CLIs run in phase 18, kitti_clis).
    Returns (report, rows, entries)."""
    t0 = time.perf_counter()
    rep, rows, entries = {"device": smi}, [], []
    for label in TS_RUNS:
        rep[label], rw, e = ts_run(torch, mods, smi, label, dev)
        rows, entries = rows + rw, entries + e
    rep["phase_s"] = time.perf_counter() - t0
    log(f"phase 17 ({smi}): {rep['phase_s']:.1f} s, {len(rows)} kernel "
        "calls held against plain")
    return rep, rows, entries


# ---- phase 18: Part-A2 and PointRCNN

PA_WORK = "build/parta2"
# label: (yaml, tree, UNetV2 (posgather forwards), the mode of a training
# step: "pallas", "as written" or None). Trees: phase 15's KITTI, phase
# 14's Waymo and ONCE
PA_RUNS = {
    "kitti PartA2": ("tools/cfgs/kitti_models/PartA2.yaml", "kitti", True,
                     "pallas"),
    "kitti PartA2_free": ("tools/cfgs/kitti_models/PartA2_free.yaml",
                          "kitti", True, None),
    "waymo PartA2": ("tools/cfgs/waymo_models/PartA2.yaml", "waymo", True,
                     None),
    "kitti pointrcnn": ("tools/cfgs/kitti_models/pointrcnn.yaml", "kitti",
                        False, "as written"),
    "kitti pointrcnn_iou": ("tools/cfgs/kitti_models/pointrcnn_iou.yaml",
                            "kitti", False, None),
    "once pointrcnn": ("tools/cfgs/once_models/pointrcnn.yaml", "once",
                       False, None),
}
PA_CLI = "tools/cfgs/kitti_models/pointrcnn.yaml"
# UNetV2 in posgather mode at eval, kernel calls a forward: K1 + K2 at the
# three stage openers and conv_out (a single tap group), K3 at the 21
# submanifold and merge convs; the inverse convs call none
PA_POSGATHER_CALLS = {"positions": 4, "posgather_conv": 4,
                      "windowed_conv": 21, "windowed_dw": 0}
PA_TRAIN = ("windowed_conv", "windowed_dw")


def pa_cfg(cfg_mod, label, impl=None):
    """The run's yaml as written (BATCH_SIZE_PER_GPU TS_BATCH), or its
    UNetV2 in SUBM_IMPL `impl` with blocks of TS_BLOCK (the kernels' modes)
    and every level's windows the main path's."""
    cfg = cfg_mod.cfg_from_yaml_file(str(ROOT / PA_RUNS[label][0]))
    cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU = TS_BATCH
    if impl is not None:
        main = cfg_mod.cfg_from_yaml_file(
            str(ROOT / CFG_FILE)).MODEL.BACKBONE_3D
        bb = cfg.MODEL.BACKBONE_3D
        bb.SUBM_IMPL, bb.WINDOWED_BLOCK = impl, TS_BLOCK
        for key in CP_WIDEN:
            bb[key] = [int(v) for v in main[key]]
    return cfg


def pa_calls_gate(label, calls, want):
    """The recorded kernel calls of one forward, counted by kernel."""
    got = dict(zip(("positions", "posgather_conv", "windowed_conv",
                    "windowed_dw"), (len(c) for c in calls)))
    if got != want:
        raise AssertionError(f"{label}: kernel calls {got}, want {want}")
    return got


def pa_pool_ms(torch, det, out, batch):
    """ts_probe's `extra` for PA_RUNS: on a training-mode forward's tensors
    the ROI pooling's ms (Part-A2: ROI-aware avg and max pooling;
    PointRCNN: ROI point pooling) and PointNet2MSG's first FPS's ms."""
    from findnpropagate_torch.ops import pointnet2, roi_pool

    roi_cfg = det.roi_head.model_cfg
    rois, pts, valid = out["rois"], out["point_coords"], out["point_valid"]
    rep = {"rois": int(rois.shape[1]), "points": int(pts.shape[1])}
    if "ROI_AWARE_POOL" in roi_cfg:
        ps = (int(roi_cfg["ROI_AWARE_POOL"]["POOL_SIZE"]),) * 3
        part = torch.cat([out["point_part_offset"],
                          out["point_cls_scores"][..., None]], dim=-1)
        rep["roiaware_avg_ms"] = timing.ms(
            lambda: roi_pool.roiaware_pool3d(rois, pts, part, valid, ps,
                                             "avg"), 1, warm=0)
        rep["roiaware_max_ms"] = timing.ms(
            lambda: roi_pool.roiaware_pool3d(rois, pts,
                                             out["point_features"], valid,
                                             ps, "max"), 1, warm=0)
        return rep
    n = int(roi_cfg["ROI_POINT_POOL"]["NUM_SAMPLED_POINTS"])
    feats = torch.cat([out["point_cls_scores"][..., None],
                       out["point_features"]], dim=-1)
    rep["roipoint_ms"] = timing.ms(
        lambda: roi_pool.roipoint_pool3d(rois, pts, feats, valid, n), 1,
        warm=0)
    rep["sampling"] = "FPS"
    rep["keypoints"] = int(det.backbone_3d.model_cfg["SA_CONFIG"]
                           ["NPOINTS"][0])
    rep["fps_ms"] = timing.ms(
        lambda: pointnet2.farthest_point_sample(
            batch["points"][..., :3].contiguous(), batch["points_mask"],
            rep["keypoints"]), 1, warm=0)
    return rep


def pa_run(torch, mods, smi, label, dev):
    """One run of PA_RUNS: the yaml as written (a gated batch-4 forward,
    no K1-K4 launch, overflow 0, then one timed forward; PointRCNN on
    KITTI at batch 1 too), for UNetV2 its posgather forwards at batch 1
    and 4 (the kernel calls of PA_POSGATHER_CALLS each, overflow 0, the
    batch-4 calls held against plain), and its training step (a warm-up
    and a timed one at batch 4: Part-A2 in pallas mode, its calls held
    against plain; PointRCNN as written, no kernel) with ts_probe and
    pa_pool_ms. Returns (report, rows, entries)."""
    from findnpropagate_torch import datasets as TD

    cfg_mod = mods[0]
    yaml, tree, unet, train = PA_RUNS[label]
    data = cycled_data(TD, TS_TREES[tree])
    rep = {"yaml": yaml, "device": smi}
    rows, entries = [], []
    batches = (1, TS_BATCH) if train == "as written" else (TS_BATCH,)
    rep["as_written"], _, _ = vn_forwards(
        torch, mods, pa_cfg(cfg_mod, label), data, f"{label} as written",
        batches, (), dev, reps=1, warm=0)
    if unet:
        pcfg = pa_cfg(cfg_mod, label, "posgather")
        need = tuple(k for k, v in PA_POSGATHER_CALLS.items() if v)
        rep["posgather"], rw, e = vn_forwards(
            torch, mods, pcfg, data, f"{label} posgather", (1, TS_BATCH),
            need, dev, reps=1, warm=0, calls_want=PA_POSGATHER_CALLS)
        rows, entries = rows + rw, entries + e
    if train is not None:
        tcfg = pa_cfg(cfg_mod, label, "pallas" if train == "pallas"
                      else None)
        rep["step"], rw, e = vn_step(
            torch, mods, tcfg, data, label,
            PA_TRAIN if train == "pallas" else (), dev)
        rows, entries = rows + rw, entries + e
        rep["probe"] = ts_probe(torch, mods, tcfg, data, label, dev,
                                extra=pa_pool_ms)
    ts_log(label, smi, rep, rows)
    return rep, rows, entries


def parta2_phase(torch, mods, smi, dev="cuda"):
    """Phase 18: PA_RUNS in turn, then the KITTI CLI chains of phases 16,
    17 and 18 side by side (kitti_clis: pillarnet, voxel_rcnn_car and
    pointrcnn, the first point-based data path, through sample_points).
    Returns (report, rows, entries)."""
    t0 = time.perf_counter()
    rep, rows, entries = {"device": smi}, [], []
    for label in PA_RUNS:
        rep[label], rw, e = pa_run(torch, mods, smi, label, dev)
        rows, entries = rows + rw, entries + e
    work = ROOT / PA_WORK
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    rep["clis"] = kitti_clis(mods[0], smi, work, {
        "kitti pillarnet": VN_RUNS["kitti pillarnet"][0],
        "kitti voxel_rcnn_car": TS_CLI, "kitti pointrcnn": PA_CLI})
    rep["phase_s"] = time.perf_counter() - t0
    log(f"phase 18 ({smi}): {rep['phase_s']:.1f} s, {len(rows)} kernel "
        "calls held against plain")
    return rep, rows, entries


# ---------------------------------------------------------------- phase 19

DDP_WORK = "build/ddp"
DDP_TIMEOUT = 600
DDP_BATCH = 2               # rows of each rank in the two-rank step
DDP_TRAIN_INFOS = "nuscenes_infos_10sweeps_train.pkl"
DDP_DEMO_FILES = 2
# the two-rank step against the one-process step on the same rows: both
# run the same kernels on bf16 operands, but the batch statistics are
# summed in another order, which moves bf16 roundings downstream.
# Gradients per leaf within DDP_GRAD_TOL of the leaf's largest (at least
# DDP_GRAD_FLOOR of the model's largest); BN buffers
# within DDP_BN_ATOL + DDP_BN_RTOL * |value| (a buffer moves by 1 - 0.99 of
# the batch's statistic, which a per-rank BN gets wrong by percents);
# parameters within DDP_PARAM_ATOL where the gradient is above the
# gradient tolerance (Adam's first step is lr * g / (|g| + 1e-8)), within
# one step (lr) elsewhere; the loss within DDP_LOSS_RTOL. On the card the
# gradients and parameters may instead stay within DDP_NOISE_FACTOR times
# what one process on the same rows in another order moves them by (each
# a largest error over ~300 leaves: their ratio was 1.03-1.34 in three
# runs, per-process statistics 7-9)
DDP_GRAD_TOL = 1e-2
DDP_GRAD_FLOOR = 1e-6
DDP_BN_ATOL, DDP_BN_RTOL = 1e-5, 1e-4
DDP_PARAM_ATOL = 2e-6
DDP_LOSS_RTOL = 1e-4
DDP_NOISE_FACTOR = 3.0


def ddp_model(cfg_mod, models_mod, synth, weights, cfg, data, dev):
    """The main yaml at full width in posgather mode with dropout 0, its
    init_random_(0) weights, in training mode, over the synthetic `data`
    config."""
    mcfg = copy.deepcopy(cfg.MODEL)
    mcfg.DENSE_HEAD["DROPOUT"] = 0.0
    ds = synth.SyntheticDataset(cfg_mod.EDict(data), cfg.CLASS_NAMES,
                                training=True)
    det = models_mod.build_network(mcfg, 10, ds, device=dev)
    weights.init_random_(det, seed=0)
    return det.train()


def ddp_snapshot(torch, det, metrics):
    return {"state": {k: v.detach().cpu().clone()
                      for k, v in det.state_dict().items()},
            "grads": {k: p.grad.detach().cpu().clone()
                      for k, p in det.named_parameters()
                      if p.grad is not None},
            "metrics": {k: float(v) for k, v in metrics.items()}}


class PinQueries:
    """TransFusionHead's top-k of its queries pinned to `indices` (B, K);
    without them the ones the head picks are kept in `picked`. An
    untrained heatmap ties at the noise of the kernels' bf16 operands, so
    a batch of 4 and two of 2 pick different queries among the ties (3.5 %
    of the parameters' entries then differ after a step); pinned, the two
    steps differ only by that noise."""

    def __init__(self, indices=None):
        from findnpropagate_torch.models.dense_heads import transfusion_head

        self.head, self.indices, self.picked = transfusion_head, indices, []

    def __enter__(self):
        self.orig = orig = self.head.top_k_lower_index_first

        def top_k(x, k):
            if self.indices is None:
                vals, idx = orig(x, k)
                self.picked.append(idx.cpu())
                return vals, idx
            idx = self.indices.to(x.device)
            return x.gather(-1, idx), idx
        self.head.top_k_lower_index_first = top_k
        return self

    def __exit__(self, *exc):
        self.head.top_k_lower_index_first = self.orig


def ddp_two_steps(torch, trainer, optimization, tp, ws, det, batch, hold,
                  queries=None):
    """Step 1 on the `queries` (PinQueries; its state, gradients, metrics
    and queries kept), then step 2 timed with the launch counts set to 0
    just before and read just after, and, with `hold`, its K1-K4 calls
    recorded."""
    tx, _ = optimization.build_optimizer(det.parameters(), TRAIN_OPT, 1000)
    step = trainer.make_train_step(det, tx)
    with PinQueries(queries) as pin:
        first = ddp_snapshot(torch, det, step(batch))
    first["queries"] = pin.picked[0] if queries is None else queries
    first["unused"] = step.ddp["unused"]
    recs = contextlib.ExitStack()
    if hold:
        k1 = recs.enter_context(record_positions(torch, tp))
        k2, k3, k4 = (recs.enter_context(Recorder(m, n, torch)).calls
                      for m, n in ((tp, "gather_conv"), (ws, "conv_kernel"),
                                   (ws, "dw_kernel")))
    with recs:
        tp.reset_launches()
        ws.reset_launches()
        dev = batch["points"].device
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(batch)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        first["step2_ms"] = 1e3 * (time.perf_counter() - t0)
        first["launches"] = launches_now(tp, ws)
        first["step2_loss"] = float(m["loss"])
    first["calls"] = (k1, k2, k3, k4) if hold else None
    return first


def ddp_worker(rank, port, work):
    """One rank of the two-rank step on the card over gloo (run by
    ddp_phase as `chip_smoke.py --ddp-worker RANK PORT DIR`)."""
    global timing
    import torch

    sys.path.insert(0, str(ROOT))
    from findnpropagate_torch import config as cfg_mod
    from findnpropagate_torch import models as models_mod
    from findnpropagate_torch.datasets import synthetic as synth
    from findnpropagate_torch.ops import _build
    from findnpropagate_torch.ops import posgather as tp
    from findnpropagate_torch.ops import windowed_sparse as ws
    from findnpropagate_torch.parallel.mesh import init_distributed
    from findnpropagate_torch.runtime import optimization, trainer
    from findnpropagate_torch.utils import timing as timing_mod
    from findnpropagate_torch.utils import weights

    timing = timing_mod
    work = Path(work)
    setup = torch.load(work / "setup.pt", weights_only=False)
    dev = setup["device"]
    if dev == "cuda":
        for name in ("posgather", "windowed_sparse"):
            _build.load(name)
    assert init_distributed(f"localhost:{port}", 2, rank, device=dev,
                            backend="gloo") == (rank, 2)
    cfg = cfg_mod.cfg_from_yaml_file(setup["cfg_file"])
    det = ddp_model(cfg_mod, models_mod, synth, weights, cfg, setup["data"],
                    dev)
    rows = slice(rank * DDP_BATCH, (rank + 1) * DDP_BATCH)
    batch = {k: v[rows].to(dev) for k, v in setup["batch"].items()}
    out = ddp_two_steps(torch, trainer, optimization, tp, ws, det, batch,
                        hold=dev == "cuda", queries=setup["queries"][rows])
    if out["calls"] is not None:
        out["held"] = [{k: r[k] for k in ("name", "call", "max_abs_err",
                                          "ms", "plain_ms")}
                       for r in hold_calls(torch, tp, ws, *out["calls"],
                                           f"ddp rank {rank}")]
    out["calls"] = None
    torch.save(out, work / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()
    return 0


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def ddp_group(key):
    """The part of the model a state key belongs to: backbone_3d,
    backbone_2d, the head's dense layers (ahead of the query selection),
    its decoder or its prediction heads (after it)."""
    parts = key.split(".")
    if parts[0] != "dense_head":
        return parts[0]
    return "dense_head." + (parts[1] if parts[1] in (
        "decoder", "prediction_head") else "dense")


def ddp_compare(torch, got, want):
    """The two-rank step's state after its first step against the
    one-process step's: each error over its tolerance (the DDP_* above),
    the largest of each kind and of each kind and model part; the share
    of the parameters' entries within their tolerance."""
    # a leaf's scale: its largest gradient, but at least DDP_GRAD_FLOOR of
    # the model's largest (a bias ahead of a batch-statistic BN has a true
    # gradient of 0 and holds f32 noise)
    floor = DDP_GRAD_FLOOR * max(float(g.abs().max())
                                 for g in want["grads"].values())
    scales = {k: max(float(g.abs().max()), floor)
              for k, g in want["grads"].items()}
    lw = want["metrics"]["loss"]
    errs = {"loss": abs(got["metrics"]["loss"] - lw)
            / (DDP_LOSS_RTOL * abs(lw))}
    parts, worst = {}, {}
    within, entries = 0, 0

    def note(kind, key, e):
        g = f"{kind} {ddp_group(key)}"
        parts[g] = max(parts.get(g, 0.0), e)
        if e > errs.get(kind, -1.0):
            errs[kind], worst[kind] = e, key

    for k, g in want["grads"].items():
        note("grad", k, float((got["grads"][k] - g).abs().max())
             / (DDP_GRAD_TOL * scales[k]))
    for k, v in want["state"].items():
        a = got["state"][k]
        if not v.is_floating_point():
            note("int", k, float(not torch.equal(a, v)) * 2)
        elif k in want["grads"]:
            g = want["grads"][k].abs()
            tol = torch.where(g > DDP_GRAD_TOL * scales[k],
                              DDP_PARAM_ATOL, TRAIN_OPT["LR"] * 1.05)
            r = (a - v).abs() / tol
            within += int((r <= 1).sum())
            entries += r.numel()
            note("param", k, float(r.max()))
        else:
            note("bn", k, float(((a - v).abs() / (
                DDP_BN_ATOL + DDP_BN_RTOL * v.abs())).max()))
    errs["param_share_within"] = within / max(entries, 1)
    return errs, worst, parts


def reference_state(torch, det, rules):
    """The model's state in the reference's names and layouts: each import
    rule inverted (sparse kernels as spconv v2 (O, kz, ky, kx, I), the
    query / key / value thirds concatenated into in_proj, the
    reference's kernel-1 Conv1d weights (O, I, 1))."""
    state = det.state_dict()
    grouped = {}
    for tkey, pkey, tr in rules:
        if pkey in state:
            grouped.setdefault(tkey, []).append((pkey, tr.__name__))
    out = {}
    for tkey, parts in grouped.items():
        vals = [state[p] for p, _ in parts]
        if len(vals) == 3:
            out[tkey] = torch.cat(vals).clone()
        elif parts[0][1] == "t_spconv":
            k, i, o = vals[0].shape
            kz, ky, kx = (3, 3, 3) if k == 27 else (k, 1, 1)
            out[tkey] = vals[0].reshape(kz, ky, kx, i, o).permute(
                4, 0, 1, 2, 3).contiguous()
        elif parts[0][1] == "t_linear" and any(
                c in tkey for c in ("class_encoding", "prediction_head",
                                    "posembed")):
            out[tkey] = vals[0][..., None].clone()
        else:
            out[tkey] = vals[0].clone()
    return out


def import_check(torch, cfg_mod, models_mod, synth, weights, cfg, dev):
    """(c): a random main-path model's state in the reference's names and
    layouts, imported into a fresh model: nothing mismatched or unmatched,
    every parameter and buffer loaded, the same eval forward."""
    from findnpropagate_torch.utils.ckpt_import import (
        import_state_dict,
        transfusion_rules,
    )

    ds = synth.SyntheticDataset(cfg_mod.EDict(synth.bench_data_cfg(1, cfg)),
                                cfg.CLASS_NAMES, training=False)
    source = models_mod.build_network(copy.deepcopy(cfg.MODEL), 10, ds,
                                      device=dev)
    weights.init_random_(source, seed=1)
    gen = torch.Generator(device="cpu").manual_seed(1)
    with torch.no_grad():
        for k, t in source.state_dict().items():
            if k.endswith(("mean", "running_mean")):
                t.copy_(0.1 * torch.randn(t.shape, generator=gen))
            elif k.endswith(("var", "running_var")):
                t.copy_(0.5 + torch.rand(t.shape, generator=gen))
            elif k.endswith("num_batches_tracked"):
                t.fill_(7)
    rules = transfusion_rules(cfg.MODEL)
    t0 = time.perf_counter()
    ref = reference_state(torch, source, rules)
    ref = {k: v.cpu() for k, v in ref.items()}
    det = models_mod.build_network(copy.deepcopy(cfg.MODEL), 10, ds,
                                   device=dev)
    report = import_state_dict(ref, det, rules)
    import_s = time.perf_counter() - t0
    loaded = {p for _, p in report["loaded"]}
    missing = sorted(set(det.state_dict()) - loaded)
    if report["mismatched"] or report["unmatched_torch"] or missing:
        raise AssertionError(f"import: mismatched {report['mismatched'][:3]}"
                             f", unmatched {report['unmatched_torch'][:3]}, "
                             f"not loaded {missing[:3]}")
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in ds.batch(range(1)).items()}
    outs = []
    for m in (source, det):
        m.eval()
        with torch.no_grad():
            out = m(batch)
            outs.append((out["transfusion_preds"], m.post_process(out)))
    (p0, d0), (p1, d1) = outs
    err = max(float((p0[k].float() - p1[k].float()).abs().max())
              for k in p0 if isinstance(p0[k], torch.Tensor))
    same = all(torch.equal(a, b) for a, b in zip(d0, d1))
    if err != 0.0 or not same:
        raise AssertionError(f"import: forward off by {err}, detections "
                             f"equal {same}")
    return {"tensors": len(ref), "loaded": len(report["loaded"]),
            "state_entries": len(det.state_dict()), "import_s": import_s,
            "forward_max_abs_err": err, "detections": int(d1.count.sum())}


def demo_check(torch, cfg_mod, synth, cfg, cfg_file, work, dev):
    """(d): DemoDataset and the detection loop of tools/demo.py over
    DDP_DEMO_FILES .bin files of bench.py's lidar_ring scenes (x, y, z,
    intensity and a zero ring column), drawn in both modes where
    matplotlib imports."""
    import importlib.util

    from findnpropagate_torch.tools import demo

    bins = work / "demo_bins"
    bins.mkdir(parents=True, exist_ok=True)
    gen = synth.SyntheticDataset(cfg_mod.EDict(synth.bench_data_cfg(
        DDP_DEMO_FILES, cfg)), cfg.CLASS_NAMES, training=False)
    for i in range(DDP_DEMO_FILES):
        pts = gen.generate_scene(i)["points"]
        np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1) \
            .astype(np.float32).tofile(bins / f"{i:06d}.bin")
    drawing = importlib.util.find_spec("matplotlib") is not None
    out = {"files": DDP_DEMO_FILES, "drawn": drawing}
    if not drawing:
        log("demo: drawing not run: matplotlib is not installed on this "
            "machine (the detections are)")
    feats = ["--set", "DATA_CONFIG.POINT_FEATURE_ENCODING.used_feature_list",
             "x,y,z,intensity",
             "DATA_CONFIG.POINT_FEATURE_ENCODING.src_feature_list",
             "x,y,z,intensity"]
    for mode in (("bev", "3d") if drawing else ("none",)):
        t0 = time.perf_counter()
        found = demo.main(["--cfg_file", cfg_file, "--data_path", str(bins),
                           "--out_dir", str(work / f"demo_{mode}"), "--mode",
                           mode, "--device", dev, *feats])
        out[f"{mode}_s"] = time.perf_counter() - t0
        if sorted(found) != [f"{i:06d}" for i in range(DDP_DEMO_FILES)]:
            raise AssertionError(f"demo: frames {sorted(found)}")
        for fid, (boxes, scores, labels) in found.items():
            if not (len(boxes) > 0 and np.isfinite(boxes).all()
                    and np.isfinite(scores).all()):
                raise AssertionError(f"demo {fid}: {len(boxes)} boxes")
        out["detections"] = {k: len(v[0]) for k, v in found.items()}
        if mode != "none":
            pngs = sorted((work / f"demo_{mode}").glob("*.png"))
            if len(pngs) != DDP_DEMO_FILES or any(
                    p.read_bytes()[:4] != b"\x89PNG" for p in pngs):
                raise AssertionError(f"demo {mode}: {pngs}")
    return out


def dist_cli(cfg_file, cfg, paper_root, work, env, dev):
    """(a): train.py --dist under `torchrun --standalone --nproc_per_node
    1` for two steps of 4 over the tree's two train frames listed four
    times (no CBGS resampling), then test.py on its checkpoint; the
    gates and the wall seconds."""
    data = ["--set", "DATA_CONFIG.DATA_PATH", str(paper_root),
            "DATA_CONFIG.BALANCED_RESAMPLING", "False",
            "DATA_CONFIG.INFO_PATH.train", ",".join([DDP_TRAIN_INFOS] * 4)]
    dev_args = [] if dev == "cuda" else ["--device", dev]
    run_dir = work / "output" / cfg.EXP_GROUP_PATH / cfg.TAG / "default"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", "-m", "findnpropagate_torch.tools.train",
         "--dist", "--cfg_file", cfg_file, "--epochs", "1", "--seed", "0",
         *dev_args, *data], cwd=work, env=env, capture_output=True,
        text=True, timeout=DDP_TIMEOUT)
    text = proc.stdout + proc.stderr
    (work / "train_dist.log").write_text(text)
    if proc.returncode != 0:
        raise AssertionError(f"train.py --dist: exit {proc.returncode}\n"
                             f"{text[-3000:]}")
    out = {"train_dist_s": time.perf_counter() - t0}
    backend = "nccl" if dev == "cuda" else "gloo"
    ckpts = sorted(p.name for p in (run_dir / "ckpt").glob("*"))
    losses = [float(t.split("=")[1]) for line in text.splitlines()
              if " it " in line for t in line.split()
              if t.startswith("loss=")]
    if (f"world size 1 ({backend})" not in text
            or "global batch 4" not in text
            or ckpts != ["checkpoint_1.pt"] or " it 0/2 " not in text
            or not losses or not all(math.isfinite(v) for v in losses)):
        raise AssertionError(f"train.py --dist: checkpoints {ckpts}, losses "
                             f"{losses}\n{text[-2000:]}")
    out["train_dist"] = {"backend": backend, "checkpoints": ckpts,
                         "losses": losses}
    out["test_s"], _ = run_cli(
        "test", ["--cfg_file", cfg_file, "--ckpt",
                 str(run_dir / "ckpt" / "checkpoint_1.pt"), *dev_args,
                 *data[:3]], work, "test_dist_ckpt")
    res = json.loads((run_dir / "eval" / "result.json").read_text())
    if not (math.isfinite(res["NDS"]) and math.isfinite(res["mAP"])):
        raise AssertionError(f"test.py on the --dist checkpoint: {res}")
    out["test_result"] = {k: res[k] for k in ("NDS", "mAP")}
    return out


def ddp_phase(torch, mods, smi, paper_root, dev="cuda", cfg_file=None):
    """Phase 19: (a) `dist_cli` in a thread of its own, beside (c) the
    reference-checkpoint import at full width, (d) the demo and (b) the
    two-rank step over gloo on the one card against the one-process step
    on the same rows (its times taken beside (a)'s processes)."""
    cfg_mod, models_mod, synth, tp, ws, lap, weights, optimization, \
        trainer = mods
    t_phase = time.perf_counter()
    cfg_file = cfg_file or str(ROOT / CFG_FILE)
    cfg = cfg_mod.cfg_from_yaml_file(cfg_file)
    work = ROOT / DDP_WORK
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    (work / "tools").symlink_to(ROOT / "tools")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = {"device": smi}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        cli = pool.submit(dist_cli, cfg_file, cfg, paper_root, work, env,
                          dev)
        out["import"] = import_check(torch, cfg_mod, models_mod, synth,
                                     weights, cfg, dev)
        log(f"reference-checkpoint import at full width ({smi}): "
            f"{out['import']}")
        out["demo"] = demo_check(torch, cfg_mod, synth, cfg, cfg_file, work,
                                 dev)
        log(f"demo ({smi}): {out['demo']}")
        out.update(two_rank_check(torch, mods, smi, cfg, cfg_file, work, env,
                                  dev))
        out.update(cli.result())
    log(f"train.py --dist under torchrun ({smi}): {out['train_dist']}, "
        f"{out['train_dist_s']:.1f} s; test.py on its checkpoint "
        f"{out['test_s']:.1f} s {out['test_result']}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 19: {out['phase_s']:.1f} s")
    return out


def two_rank_check(torch, mods, smi, cfg, cfg_file, work, env, dev):
    """(b): one process on four rows (its queries kept), one process on
    rank 0's two rows alone, then two ranks over gloo on the one card on
    two rows each, all on the four rows' queries (PinQueries)."""
    cfg_mod, models_mod, synth, tp, ws, lap, weights, optimization, \
        trainer = mods
    out = {}
    if dev == "cuda":
        torch.cuda.empty_cache()
    data = synth.bench_data_cfg(2 * DDP_BATCH, cfg)
    ds = synth.SyntheticDataset(cfg_mod.EDict(data), cfg.CLASS_NAMES,
                                training=True)
    batch = {k: torch.from_numpy(v) for k, v in
             ds.batch(range(2 * DDP_BATCH)).items()}
    one = ddp_model(cfg_mod, models_mod, synth, weights, cfg, data, dev)
    full = ddp_two_steps(torch, trainer, optimization, tp, ws, one,
                         {k: v.to(dev) for k, v in batch.items()}, False)
    del one
    # the noise of the comparison: one process on the same rows in another
    # order (the same step; other sums, other bf16 roundings)
    order = list(range(DDP_BATCH, 2 * DDP_BATCH)) + list(range(DDP_BATCH))
    again = ddp_model(cfg_mod, models_mod, synth, weights, cfg, data, dev)
    other = ddp_two_steps(torch, trainer, optimization, tp, ws, again,
                          {k: v[order].to(dev) for k, v in batch.items()},
                          False, full["queries"][order])
    del again
    noise = ddp_compare(torch, other, full)[0]
    # the gates tell per-process statistics apart: one process on rank 0's
    # rows alone must fail them in its BN buffers
    half = ddp_model(cfg_mod, models_mod, synth, weights, cfg, data, dev)
    alone = ddp_two_steps(torch, trainer, optimization, tp, ws, half,
                          {k: v[:DDP_BATCH].to(dev)
                           for k, v in batch.items()}, False,
                          full["queries"][:DDP_BATCH])
    del half
    if dev == "cuda":
        torch.cuda.empty_cache()
    torch.save({"device": dev, "cfg_file": cfg_file, "batch": batch,
                "data": data, "queries": full["queries"]}, work / "setup.pt")
    port = str(free_port())
    t_b = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--ddp-worker",
         str(r), port, str(work)], env=env,
        stdout=open(work / f"rank{r}.log", "w"), stderr=subprocess.STDOUT)
        for r in range(2)]
    try:
        codes = [p.wait(timeout=DDP_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if codes != [0, 0]:
        tails = [(work / f"rank{r}.log").read_text()[-2000:]
                 for r in range(2)]
        raise AssertionError(f"two-rank step: exits {codes}\n" +
                             "\n".join(tails))
    out["two_rank_s"] = time.perf_counter() - t_b
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    for k, v in ranks[0]["state"].items():
        if not torch.equal(v, ranks[1]["state"][k]):
            raise AssertionError(f"two-rank step: the ranks' {k} differ")
    errs, worst, parts = ddp_compare(torch, ranks[0], full)
    alone_errs = ddp_compare(torch, alone, full)[0]
    # gradients and parameters within their tolerances, or within
    # DDP_NOISE_FACTOR times the noise of the comparison where the noise
    # alone exceeds them (the kernels' bf16 operands); the rest within
    # their tolerances
    over = {k: v for k, v in errs.items() if k != "param_share_within"
            and v > max(1.0, DDP_NOISE_FACTOR * noise[k]
                        if k in ("grad", "param") else 1.0)}
    if over:
        raise AssertionError(f"two-rank step against one process: errors "
                             f"over tolerance {errs} at {worst}; the same "
                             f"rows in another order: {noise}")
    if not alone_errs["bn"] > 1:
        raise AssertionError("two-rank step: rank 0's rows alone pass the "
                             f"gates, {alone_errs}")
    for r, res in enumerate(ranks):
        if dev == "cuda" and res["launches"] != TRAIN_LAUNCHES:
            raise AssertionError(f"two-rank step rank {r}: launches "
                                 f"{res['launches']}, want {TRAIN_LAUNCHES}")
    out["rank0_rows_alone_errors"] = alone_errs
    out["other_order_errors"] = noise
    out["two_rank"] = {
        "rows_per_rank": DDP_BATCH, "errors": errs, "worst": worst,
        "errors_by_part": parts, "loss": ranks[0]["metrics"]["loss"],
        "one_process_loss": full["metrics"]["loss"],
        "unused_parameters": ranks[0]["unused"],
        "launches_per_rank": [r["launches"] for r in ranks],
        "ddp_step_ms": [r["step2_ms"] for r in ranks],
        "one_process_step_ms": full["step2_ms"],
        "held_calls_per_rank": [len(r.get("held") or []) for r in ranks],
        "held_max_abs_err": {n: max([h["max_abs_err"] for r in ranks
                                     for h in r.get("held") or []
                                     if h["name"] == n] or [0.0])
                             for n in TRAIN_LAUNCHES}}
    log(f"two ranks over gloo on one card, {DDP_BATCH} rows each, against "
        f"one process at {2 * DDP_BATCH} ({smi}): {out['two_rank']} "
        f"(errors over their tolerances); one process on the rows in "
        f"another order: {noise}; on rank 0's rows alone: {alone_errs}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--train-batch", type=int, default=4)
    ap.add_argument("--train-steps", type=int, default=3,
                    help="timed optimizer steps after the warm-up")
    ap.add_argument("--out", default=None,
                    help="write every measurement to this JSON file")
    ap.add_argument("--profile", default=None,
                    help="write a torch.profiler kernel table of one "
                    "forward at the largest batch to this file, and of "
                    "one training step to <file>.train.txt")
    ap.add_argument("--before", default=None,
                    help="a checkout of an earlier commit of this repo "
                    "whose K1, K2, K3 and P1-P3 are timed beside this "
                    "one's")
    args = ap.parse_args()
    global timing

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from findnpropagate_torch import config as cfg_mod
        from findnpropagate_torch import models as models_mod
        from findnpropagate_torch.datasets import synthetic as synth
        from findnpropagate_torch.ops import _build, lap
        from findnpropagate_torch.ops import gather_probes as gp
        from findnpropagate_torch.ops import posgather as tp
        from findnpropagate_torch.ops import sparse_ops
        from findnpropagate_torch.ops import windowed_sparse as ws
        from findnpropagate_torch.runtime import optimization, trainer
        from findnpropagate_torch.utils import timing, weights
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 3

    if args.before:
        args.before = load_before(args.before)
    report = {}
    # ---- 1. device + build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    sources = ["posgather", "windowed_sparse", "gather_probes"]
    _build.build_all(sources)
    for name in sources:
        _build.load(name)
    report["build_s"] = time.perf_counter() - t0
    log(f"build: {report['build_s']:.1f} s (nvcc, in parallel: "
        + ", ".join(f"{n} {_build.BUILD_SECONDS.get(n, 0.0):.1f} s"
                    for n in sources) + ")")
    for name in sources:
        for line in _build.PTXAS_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log("  ptxas:", line.strip())
        spilled = {fn: n for fn, n in _build.spills(
            _build.PTXAS_LOG.get(name, "")).items() if n}
        if spilled:
            raise AssertionError(f"register spills in {name}: {spilled}")

    cfg = cfg_mod.cfg_from_yaml_file(str(ROOT / CFG_FILE))
    nmax = max(max(args.batches), 2)
    ds = synth.SyntheticDataset(
        cfg_mod.EDict(synth.bench_data_cfg(nmax, cfg)), cfg.CLASS_NAMES,
        training=False)
    det = models_mod.build_network(copy.deepcopy(cfg.MODEL), 10, ds)
    weights.init_random_(det, seed=0)
    batches = {b: {k: torch.from_numpy(v).cuda()
                   for k, v in ds.batch(range(b)).items()}
               for b in args.batches}

    # ---- 2. kernels vs plain: corner cases, then the main path's own
    # arguments
    report["corner_cases"] = corner_phase(torch, tp, ws, sparse_ops)
    report["probe_corner_cases"] = probe_corners(torch, gp)
    with record_positions(torch, tp) as pos_calls, \
            Recorder(tp, "gather_conv", torch) as conv_rec:
        det.post_process(det(batches[min(args.batches)]))
        torch.cuda.synchronize()
        # K1's tap sub-window mode (not on the main path: the port ranks
        # over the union window) at L0, with the yaml's L0 tap window
        src = pos_calls[0][0][0]
        s1 = det.backbone_3d.level_shapes[0]
        bb = cfg.MODEL.BACKBONE_3D
        tp.compute_positions(
            src, src, sparse_ops.yxz_offset_deltas((3, 3, 3), s1),
            int(bb.WINDOWED_BLOCK), int(bb.WINDOWED_WINDOW[0]),
            tap_window=int(bb.TAP_WINDOW[0]),
            sentinel_start=sparse_ops.yxz_sentinel_start(s1))
    rows = check_kernels(torch, tp, pos_calls, conv_rec.calls, args.before)
    report["kernel_calls"] = rows
    log_positions_rows([r for r in rows if r["name"] == "positions"])
    for r in rows:
        if r["name"] == "positions":
            continue
        dev = (f" (device {r['device_ms']:.4f}" + (
            f", before {r['before_device_ms']:.4f}"
            if "before_device_ms" in r else "") + ")"
            if "device_ms" in r else "")
        log(f"{r['name']:15s} call {r['call']:2d} vt={r['vt']} "
            f"{r['cin']}->{r['cout']} epi={int(r['epilogue'])} "
            f"err {r['max_abs_err']:.3g}  ms {r['ms']:.4f}{dev}  plain "
            f"{r['plain_ms']:.3f}  bound {r['bound_ms']:.4f} "
            f"({r['bound_by']})")

    # ---- 3. main path
    report["main_path"] = []
    for b in args.batches:
        res = run_main_path(torch, det, tp, batches[b], b, args.reps)
        report["main_path"].append(res)
        log(f"main path batch {b}: {res['ms_per_scan']:.2f} ms/scan "
            f"{res['scans_per_s']:.2f} scans/s, launches "
            f"{res['launches_per_forward']}, active/level "
            f"{res['active_voxels_per_level']}, peak "
            f"{res['peak_mem_gb']:.2f} GiB")

    if args.before is not None:
        b = min(args.batches)
        ab = k1_before_after(torch, args.before, lambda: forward_ms(
            torch, det, batches[b], args.reps)[0])
        report["main_path_k1_before_after_ms"] = {"batch": b, **ab}
        log(f"main path batch {b}, ms/batch with the earlier / this "
            f"compute_positions: {ab}")

    if args.profile:
        report["profile"] = profile_forward(
            torch, det, batches[max(args.batches)], args.profile)
        log(f"profile batch {max(args.batches)}: {report['profile']}")

    # ---- 4. reference on a small input
    report["reference_rel_err"] = reference_phase(torch, cfg_mod, synth,
                                                  models_mod, weights)
    log(f"reference (card vs CPU, narrow model): "
        f"{report['reference_rel_err']}")

    # ---- 5, 6. training path and its kernels
    mods = (cfg_mod, models_mod, synth, tp, ws, lap, weights, optimization,
            trainer)
    train_rows = training_phase(torch, mods, cfg, args, report)
    report["train_kernel_calls"] = train_rows

    # ---- 7. pallas-mode forward
    report["pallas_mode_rel_err"], report["pallas_kernel_calls"], \
        report["pallas_forward"] = pallas_phase(
            torch, models_mod, cfg, ds, det, batches[min(args.batches)], tp,
            ws, args.reps, args.before)
    log_conv_rows(report["pallas_kernel_calls"])
    log(f"pallas-mode forward vs posgather forward (batch "
        f"{min(args.batches)}): {report['pallas_mode_rel_err']}")

    # ---- 8. the ported probes and their kernels
    report["probe_launches"], report["probe_kernel_calls"], \
        report["probe_output"] = probes_phase(torch, gp, args.before)
    log(f"probe launches: {report['probe_launches']}")

    # ---- 9. the Greedy Box Seeker: nuScenes, SEG, KITTI
    report["seeker"] = seeker_phase(torch, args.profile)

    # ---- 10. Propagate: self-training through train_st.main, then the
    # extraction CLI's frame loop
    report["propagate"], st_detector, st_cfg, st_frustum = propagate_phase(
        torch, tp, ws, smi, args.profile)

    # ---- 11. open vocabulary: relabeling, ensembles, recall, alt mode
    report["open_vocab"] = open_vocab_phase(torch, tp, ws, smi, st_detector,
                                            st_cfg, st_frustum)
    del st_detector

    # ---- 12. the paper's self-training yaml as written, and KITTI
    report["paper"] = paper_phase(
        torch, tp, ws, smi, cfg_mod, synth, models_mod, weights,
        report["propagate"]["ms_per_step_epoch1"],
        args.profile and args.profile + ".paper")

    # ---- 13. CenterPoint: both nuScenes yamls, the narrow model against
    # the CPU, CenterHeadCLIP and VoxelBackBone8x, train.py and test.py
    report["centerpoint"], cp_rows, cp_entries = centerpoint_phase(
        torch, mods, smi, args, ROOT / PAPER_WORK / "nuscenes")
    report["centerpoint_kernel_calls"] = cp_rows

    # ---- 14. datasets: Waymo (three yamls, create_infos, the CLIs), ONCE
    # (create_infos and the CLIs), Lyft, Custom, Argo2, Pandaset
    report["datasets"], ds_rows, ds_entries = datasets_phase(
        torch, mods, smi, args)
    report["datasets_kernel_calls"] = ds_rows

    # ---- 15. anchor heads and pillar VFEs: KITTI (pointpillar, second,
    # a posgather step, train.py / test.py), Lyft, nuScenes, Waymo
    report["anchor"], an_rows, an_entries = anchor_phase(torch, mods, smi)
    report["anchor_kernel_calls"] = an_rows

    # ---- 16. VoxelNeXt, VoxelNeXt2D, PillarNet (also train.py / test.py
    # on KITTI) and TransFusionHeadAM
    report["voxelnext"], vn_rows, vn_entries_ = voxelnext_phase(
        torch, mods, smi)
    report["voxelnext_kernel_calls"] = vn_rows

    # ---- 17. the voxel two-stage detectors (SECONDNetIoU, VoxelRCNN,
    # PVRCNN, PVRCNNPlusPlus)
    report["two_stage"], ts_rows, ts_entries = two_stage_phase(torch, mods,
                                                               smi)
    report["two_stage_kernel_calls"] = ts_rows

    # ---- 18. Part-A2 and PointRCNN, train.py / test.py on pointrcnn
    report["parta2"], pa_rows, pa_entries = parta2_phase(torch, mods, smi)
    report["parta2_kernel_calls"] = pa_rows

    # ---- 19. train.py --dist under torchrun (NCCL, one rank), the
    # reference-checkpoint import at full width, the demo, and two ranks
    # over gloo on the one card against one process
    report["ddp"] = ddp_phase(torch, mods, smi, ROOT / PAPER_WORK / "nuscenes")

    # ---- 20. result lines
    first_batch = report["main_path"][0]["launches_per_forward"]
    pick = {
        # K1 at L0 (first call); K2 at the L0 16->16 subm conv with the
        # fused epilogue (the first call is the 4->16 input conv)
        "positions": next(r for r in rows if r["name"] == "positions"),
        "posgather_conv": [r for r in rows
                           if r["name"] == "posgather_conv"][1],
    }
    # K3 at the L1->L2 strided conv 32->64 (second forward call), K4 at an
    # L1 32->32 submanifold conv (the largest target list)
    pick["windowed_conv"] = [r for r in train_rows
                             if r["name"] == "windowed_conv"][1]
    pick["windowed_dw"] = next(
        r for r in train_rows if r["name"] == "windowed_dw"
        and r["cin"] == 32 and r["cout"] == 32)
    train_launches = report["train"]["steps"][0]["launches"]
    totals = {}
    for r in train_rows:
        key = (r["name"], r.get("direction", ""))
        tot = totals.setdefault(key, {"ms": 0.0, "plain_ms": 0.0,
                                      "bound_ms": 0.0, "calls": 0})
        for k in ("ms", "plain_ms", "bound_ms"):
            tot[k] += r[k]
        tot["calls"] += 1
    report["train_kernel_totals"] = {" ".join(k).strip(): v
                                     for k, v in totals.items()}
    log("training kernels, summed over one step's calls: "
        + json.dumps(report["train_kernel_totals"]))
    kernels = []
    for name, r in pick.items():
        # launches: the inference forward's for K1 and K2 (as before), one
        # training step's for K3 and K4; launches_train_step for all four.
        # library_ms: torch.searchsorted for K1 (k1_library); no single
        # PyTorch call computes a rank-gather or union-window sparse conv,
        # or its weight gradient
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": first_batch.get(name, train_launches[name]),
            "launches_train_step": train_launches[name],
            "launches_st_step": report["propagate"]["launches_per_step"][
                name],
            "launches_st_extraction_batch": report["propagate"][
                "launches_per_extraction_batch"][name],
            "launches_paper_st_step": report["paper"]["steps"][0][
                "launches"][name],
            "launches_open_vocab_extraction_batch": report["open_vocab"][
                "launches_per_extraction_batch"][name],
            "launches_ddp_rank_step": [
                r[name] for r in report["ddp"]["two_rank"][
                    "launches_per_rank"]],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
            "library_device_ms": r.get("library_device_ms"),
            "device_ms": r.get("device_ms"), "call": r["call"],
            "vt": r["vt"]})
    # the probes' kernels, at the probes' own shapes: P1 at probe_gather's
    # stacked taps (27 x 1024 over a (16, 2048) bf16 window), P2 at
    # probe_posgather's one-hot reference (weight stage, 118 blocks), P3 at
    # band 3; launches: the probes' run
    probe_rows = report["probe_kernel_calls"]
    probe_pick = {
        "take_along": next(
            r for r in probe_rows if r["name"] == "take_along"
            and r["options"].get("taps") and r["scalars"] == [1]),
        "onehot_gather": next(
            r for r in probe_rows if r["name"] == "onehot_gather"
            and "wt" in r["options"]),
        "banded_gather_conv": next(
            r for r in probe_rows if r["name"] == "banded_gather_conv"
            and r["scalars"] == [3]),
    }
    for name, r in probe_pick.items():
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": report["probe_launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "library_device_ms": r["library_device_ms"],
            "device_ms": r["device_ms"], "call": r["call"],
            "shapes": r["shapes"]})
    # phases 13-18: per yaml, each kernel's calls of one batch-4 forward
    # and of one training step, summed
    kernels += cp_entries + ds_entries + an_entries + vn_entries_ \
        + ts_entries + pa_entries
    report["kernels"] = kernels
    report["device"] = smi
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--ddp-worker"]:
            sys.exit(ddp_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
