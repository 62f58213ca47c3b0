"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--parent DIR]

``--parent DIR``: DIR holds the parent commit's tree (e.g. unpacked by
``git archive``); its own kernel wrappers (``ops/cuda_kernels.py``) are
loaded, its kernels built from its sources, and its K1, K5, K8 and K9 and
the host time of every wrapper timed against this tree's in turns, on the
same inputs, as "parent" times.

Phases (any failure raises, so the script exits non-zero):

1. Device: requires CUDA, prints the card's name, power limit, SM count and
   maximum SM clock (the operation bounds' issue rates), builds the CUDA
   kernels from kornia_tpu_torch/ops/csrc/ and prints the build time.
2. Kernels vs their plain PyTorch versions on the card, at main-path
   shapes: the 8 pyramid levels of both 480×752 views (K1: all levels in
   one launch, bit-equal to the plain version and to the one-level calls),
   2000 keypoints (with border keypoints and pairs that straddle two
   levels). All must be bit-equal (max_abs_err 0); K3 by both its entries:
   brief_rotated (windows + cos/sin + pattern → bits, which the path runs)
   against its plain version, brief_sample (the index form) against its
   own, and brief_rotated's samples against brief_sample on
   _brief_tap_coords' indices.
3. The slice at full size on a seed-made scene with known pose: two
   480×752 views of two textured, non-coplanar planes; ORB (OrbConfig())
   on both, Hamming matching, the two-view bootstrap (TwoViewParams()).
   Launch counts for the pair must be fast_harris 2 (one a frame),
   windows_paired 4, brief_rotated 2; both frames' ORB features must equal
   those of the route with one K1 launch per level, and their descriptors
   the index form's on the same windows and angles; rotation error ≤ 0.5°,
   translation direction ≤ 5°, ≥ 100 inliers. The same pair is then run on
   the CPU and the shares of pyramid pixels, selected keypoints and
   descriptor bits that differ are printed (keypoints: ≤ 1%).
4. Times: of each kernel, its plain version and one PyTorch library call
   computing the same function where there is one, two times each: the
   device time (torch.profiler over 20 back-to-back calls: the summed
   device time of the kernels the call launches, taken only from a trace
   that holds the device record of every one of them) and the call time (CUDA
   events around one call, median of 20: what one caller waits, Python
   wrapper and launch latency included); per wrapper the host
   microseconds per call (1000 calls without a synchronise). Each stage
   and the whole pair by call time. K1 all levels in one launch against
   one launch per level (and the parent's kernel with --parent).
5. rectify (the warping slice's path): a raw, distorted EuRoC-size stereo
   pair of the same scene (0.11 m baseline, < 1° relative rotation,
   K_EUROC and radtan distortion) → StereoRectifier.from_calib →
   rectify_left/right (K7 with data maps, 2 launches) → ORB ×2 → match.
   The median |y1 − y2| of the matches must be < 0.5 px.
6. warp: a seed-made 1080×1920×3 u8 image through warp_affine (10°, 30°,
   scale 0.5), warp_perspective, undistort_image and remap (bilinear and
   nearest, zeros and border): one K7 launch each, each bit-equal to the
   plain version, timed beside the plain version and
   torch.nn.functional.grid_sample on the same map (on a ready f32 NCHW
   tensor, and with the conversion from and to u8 HWC). warp_affine with a
   matrix made on the card runs under torch.cuda.set_sync_debug_mode
   ("error"): it must not wait for the device, and must equal the call
   with the same matrix on the host bit for bit. Then the traffic that
   route is for, 50 frames whose matrix comes out of device work still in
   the queue: ms per frame with the matrix left on the card and with it
   copied to the host first, behind no, 0.4 ms and 2.7 ms of queued work.
7. lane_shift: K8 at the shapes the JAX package's sheared branch gives it
   for the 1080p 30° warp (s = 1920, ht = 3944, 3 channels).
8. shear: warp_affine(method="shear") at 1080p RGB, 25° (canvas 3072): K9
   row mode shear_x 4 launches, column mode shear_y 2, each call held to
   its plain version; each column pass takes a row pass's output as it is
   and hands its own to the next row pass (no transpose copy). One pass of
   each mode timed, beside the transposing chain the column mode replaced.

9. orb_variants (the third slice): the other describe forms of ORB on the
   480×752 frame with OrbConfig(): describe="unpaired" (K4 windows 2, K3
   brief_rotated 1 on (K, 48, 128) windows, fast_harris 1) with
   descriptors and angles equal to the paired run's and to the index
   form's; brief="lane_gather" (K5 lane_gather 4, each a broadcast-index
   call: one (K, 128) index row per 48 window rows), bit-equal descriptors
   again, K5 in both modes against its plain version and timed, and the
   describe against the route with the expanded index, in turns;
   OrbConfig(n_features=2001) (an odd budget sum);
   describe="gather"; the quadtree pipeline (fast_score 8, windows 16,
   brief_rotated 8: its per-level detection runs K1's score-only entry,
   as the reference's runs fast_score_pallas;
   keypoints kept per level); harris_at_windows at the
   level-0 keypoints (windows 1) against the dense central-gradient map.
   Then ORB with OrbConfig(n_levels=17, scale_factor=1.1): fast_harris 2
   (16 levels, then 1), features equal to the route with one K1 launch
   per level.
10. lk: frame 2 = warp_affine (K7) of frame 1 by a 2° rotation about the
   centre plus a (6, −4) px shift; the valid ORB keypoints of frame 1 are
   tracked with PyrLKParams() by "taps", "windows" and "gather". For
   "taps" ≥ 90% of the interior points must be tracked with a median
   end-point error < 0.1 px; the Newton iterations and K4 launches per
   level are printed.
11. preprocess: a seed-made 1080×1920×3 u8 image → 640×640 with the
   ImageNet mean/std (K6 preprocess 1 launch), bit-equal to the kernel's
   own arithmetic in PyTorch ops and within 2e-6 of the dense float32
   matrix products; the same image → 224×224 (tap weights that are not
   dyadic); one letterbox case (360×640 placed on the pad canvas).
12. host: microseconds of host time per call of every wrapper on the
   main path's recorded inputs (1000 calls, no synchronise), twice; with
   --parent in turns with the parent tree's wrappers.
13. track (run before host): the SLAM loop's per-frame tracking step at
   its full width. A map of views 1 and 2 (ORB with SlamConfig()'s
   OrbConfig(n_features=1000, n_levels=4), each valid keypoint lifted to
   its exact 3-D point on the planes, packed descriptors, padded to 2048
   rows) and a third view at a known pose (rotation (−1.5°, 1.5°, −0.5°),
   centre (−0.2, 0.1, 0.1); its ORB padded to 1024 rows) go through
   slam.track_step with SlamConfig() (ratio 0.8, distance ≤ 64, 3 px,
   256 × 6-point EPnP hypotheses, 2 LO refits, 10 LM steps), the draw
   from a CUDA generator seeded with SEED. The frame's ORB launches
   fast_harris 1, windows_paired 2, brief_rotated 1; the step runs under
   torch.cuda.set_sync_debug_mode("error") (it must not wait for the
   device), must recover the pose within 0.1° and 0.02 units of centre
   with inliers ≥ half the matches, and with the same draw must equal
   the CPU route's matches, pose (1e-4 rad, 1e-3) and n_inliers (±2).
   Call and device ms of the step, the packed match alone,
   solve_pnp_ransac alone and the frame's ORB; the step's kernel launches
   and device busy share.
14. backend (the eighth slice, run after track): the SLAM back end,
   plain PyTorch (no hand kernel: cases (a)-(d) must launch none).
   (a) local BA as the loop runs it: 5 keyframes (SlamConfig().ba_window,
   ba_iterations 10, Huber 2), 1500 points each seen by 2-5 of them, 0.5
   px noise, keyframes 2-4 and the points perturbed, bucketed as
   _bundle_adjust buckets (keyframes 0 and 1 fixed); the cost must fall,
   every pose end within 0.5° of the truth. (b) dense global BA on
   bench_scaling.py's synth_problem(170, 3000, seed 1, vis 0.2) (~102k
   observations, 12 iterations): final cost < 0.1 x initial; one Schur
   step against the CPU route. (c) synth_problem(600, 8000, seed 1, vis
   0.0375) (~180k observations): solver "auto" must pick PCG (60 CG
   steps), final cost < 0.1 x initial and <= 1.2 x the dense solve's;
   one PCG reduced solve timed in turns against the batched-gemv form
   of its per-block products (GemvMatvec).
   (d) PGO as _run_pgo runs it (15 iterations) on a ring of 256
   keyframes: drifted odometry and second-previous edges, 8 exact loop
   edges at weight 100, bucketed with identity padding; cost < 0.5 x and
   translation ATE < 0.75 x the initial. (e) a Vocabulary (k 10, depth
   4) built from 24,000 descriptors (the ORB of views 1-3 and three
   bit-flipped copies), 50 keyframes of 1000 in a BowDatabase, a noisy
   copy of keyframe 17 must rank it first, card word ids equal to the
   CPU route's. (a), (b), (c) and (d) run once under
   torch.cuda.set_sync_debug_mode("error") and are held to the CPU route
   (the reference's own bound for two summation orders: costs 1e-4 /
   0.05, poses 1e-3). Per case: call ms (cuda_ms) and device ms
   (device_ms, or the busy time of one profiled solve where a solve
   launches tens of thousands of kernels) of the solve and per LM
   iteration, launches per iteration and the device busy share.
15. slam (the ninth slice, run after backend): the SLAM frame loop at full
   width. MonocularSlam.process_frame over SLAM_FRAMES 480×752 u8 frames
   of the two-plane scene on an out-and-back path (K_EUROC, σ 2 noise, the
   return revisits the start), SlamConfig() widths (1000 features, 4
   levels, ba_window 5, 10 local and 12 global BA iterations) with the
   loop thresholds of tests/test_slam.py's image loop test, a vocabulary
   (k 8, depth 3) built by the port from the ORB of every 6th frame.
   Counted from 0 after the vocabulary: fast_harris 1, windows_paired 2,
   brief_rotated 1 a frame and no other kernel; the K1-K3 calls of the
   first and last frames bit-equal to their plain versions. Gates on the
   ground truth (slam_gates): tracking at the end, >= 70% of frames
   tracked, >= 5 keyframes, a loop closed to a keyframe < 8, keyframe
   ATE RMSE (sim3-aligned) < SLAM_ATE_BOUND, set from slam_spread.py's
   card runs. Per frame kind (bootstrap, tracked, keyframe, loop closure)
   call ms p50 / p95; from a second run with each frame under the
   profiler and sync debug mode "warn": kernel launches, copies and host
   syncs a frame, the device busy share, and the Python lines that
   synchronise; frames/s, map points, keyframes, loop edges, ATE; the
   host ms of each stage of the loop.
16. imgproc (the tenth slice, run after preprocess): a seed-made, textured
   1080×1920×3 u8 frame. The fast_detector path: color.rgb_to_gray →
   fast.fast_detect(threshold 20, 2048 keypoints), then with an ROI mask
   (the left 60% of the frame, 1 on the border too), then without the NMS:
   one K1 score-only launch (fast_score) each and no other kernel; K1's
   output bit-equal to its plain version; keypoints (xy, score, mask) equal
   to the CPU route's on the same gray; no keypoint outside the ROI or
   within 3 px of the border; no host synchronisation under
   torch.cuda.set_sync_debug_mode("error") after a warm-up; call ms
   (median of 20), device ms, launches and host us per call. K1's
   score-only forms timed beside their plain versions and bound (the
   kernels line's K1 row gains them under ``cases``). Then the dense
   chain: every public function of the slice's modules once at 1080p, on
   gray or RGB as it takes, under sync debug mode "error" after a warm-up,
   no hand kernel launched, held to the CPU route on the same input
   (IMGPROC_TOL); one ``imgproc <function>`` line each with call and
   device ms, launches and the largest difference.
17. geometry15b (the eleventh slice, run after imgproc): fast_detect on the
   imgproc frame's 1080p gray at arc lengths 9, 10, 11 and 12, NMS on and
   off, and n = 10 with the ROI mask: one K1 score-only launch each, K1
   bit-equal to its plain version at the same n, keypoints equal to the CPU
   route's; K1 timed per form beside its plain version and its bound (the
   integer operations of the kernel's arc loop: 99 a pixel for n = 9, 131
   for n = 10-16). ORB (OrbConfig()) on the two-plane 480×752 pair, match,
   estimate_relative_pose(solver="5pt"): fast_harris 2, windows_paired 4,
   brief_rotated 2 and no other kernel; rotation < 0.5°, direction < 3°
   from the truth (the reference test's gates); call ms and launches of
   the 5-point two-view. ICP on a seed-made 16,384-point scan and the same
   scan moved by 1° and 5 cm (icp_scan), 30 iterations, under sync debug
   mode "error", no hand kernel: within 0.01° and 1 mm of the truth; after
   4 iterations the CPU route's rotation within 1e-4 of the card's. An AugmentationPipeline (flip,
   jitter, blur, affine, erasing) over the 1080p frame and apply_batch over
   4 such frames, under sync debug mode "error": K7 remap 1 launch an
   image, the output equal to the call with the same draws replayed, and
   within IMGPROC_TOL of the CPU route on those draws. warp_frame_depth at
   480×752 with a seed-made depth map: K7 remap 1, the CPU route within
   IMGPROC_TOL.
18. apriltag (the twelfth slice, run after geometry15b): no hand kernel
   runs (the counts are 0 after a decode and after each dense CCL). A
   1080×1920 u8 gray frame (tag_scene): the imgproc frame's gray, 16
   tag36h11 tags (render_tag, 0.16 m) warped in by numpy at known poses
   on a 4 × 4 layout (depth 1.2–3.0 m, tilt 30–40°, fx = fy = 1400), σ 4
   noise. AprilTagDecoder(DetectorConfig(), device="cuda").decode: 16/16
   tags at hamming 0, and TAG_GATES on the corners against the projected
   truth and on estimate_tag_pose against the known poses. The threshold
   bit-equal to the CPU route; the detections equal to the CPU route's, to
   a device-tensor input's, and the numpy mid-pipeline's within 1e-3 px.
   Per-stage ms (KORNIA_TPU_APRILTAG_TRACE, median of 20), decode call
   p50 / p95 at quad_decimate 1 and 2, the threshold's device ms, launches
   and byte bound, and a traced decode's launches, host syncs and device
   busy share. connected_components on the threshold's black class at
   connectivity 4 and 8: sweeps, whether the cap was reached, call and
   device ms, launches and host syncs; labels equal to the CPU route's, and
   once converged, relabel_sequential equal to connected_components_host.
   The host formats once each: find_contours on a 480×752 mask, an RVL
   round trip of a 480×752 u16 depth map, PLY and PCD round trips of
   100,000 points in a temporary directory.
19. io (the thirteenth slice, host code; no hand kernel), in a temporary
   directory: the 40 slam_sequence frames written as a TUM RGB-D layout
   (RGB PNG, u16 depth PNG, groundtruth.txt) and read back through
   io.TumRgbdDataset (frames, depth and poses equal), EuRoC and KITTI
   layouts of 5 frames likewise; the 1080p imgproc frame through PNG, TIFF
   and lossless WebP (equal) and JPEG q95 (mean |error| printed and held
   under JPEG_TEXTURED_BOUND: the frame is noise, far from the smooth
   image of tests/test_io.py's corridor, which a 1080p gradient is held to:
   mean < 4), write and read ms each; 60 frames at 480×752 written through
   VideoWriter(codec="mjpg"), read back by MjpegReader and by cv2's
   VideoReader (count, fps, size, mean error < 12 as tests/test_io.py),
   ms a frame; NativeCapture over a directory of PPM frames (equal).
20. vlm (the thirteenth slice; no hand kernel, the counts stay 0):
   SmolVLM-256M (smolvlm_256m(), float32, random weights from seed 0) on
   the card serves three requests through the port's entry points: (1)
   the 1080p frame written as a JPEG, io.read_image_any_rgb8,
   preprocess_image(img, 512), build_prompt_tokens of 10 ids and 64
   <image> tokens, 32 greedy tokens with a stream callback; (2) the same
   at temperature 0.7 with a seeded generator, twice, equal tokens; (3)
   the io phase's AVI through VideoReader, sample_video(reader, 4),
   preprocess_video(..., 512), four rows, 32 greedy tokens. Then one
   greedy request of 16 tokens each from PaliGemmaConfig() (224 px, 256
   image tokens, vocabulary 257,216), smolvlm_500m() and smolvlm_2_2b(),
   built one at a time and freed. Gates: every logit finite; n_generated
   and the stream as the reference defines them; SmolVLM-256M's prefill
   logits on the card within VLM_LOGIT_TOL of the CPU route on the same
   weights, and its greedy tokens equal to the CPU's (teacher-forced on
   the card's tokens) wherever the CPU's top-2 margin exceeds 10×
   VLM_LOGIT_TOL (steps below it are printed); the four video rows'
   prefill logits within VLM_LOGIT_TOL of the CPU route; the same for
   each of the other three presets at 2 layers of depth and full width.
   Printed per model: build, preprocess, vision-encode, prefill and
   request ms; from generate's own decode loop (CUDA events at each
   decoder call, recorded by a forward hook) decode ms a token p50 / p95
   and tokens/s, and from two traced requests (n and 2 tokens) launches,
   copies and device ms a decode step; host syncs a request, the device
   busy share of a traced request, max_memory_allocated, FLOPs a prefill and a decode token and their
   share of the float32 peak (2 × the f32 issue rate), and the decode's
   byte bound (the weights a token at 3.35 TB/s).

21. parallel (the fourteenth slice, run after slam): the distributed
   layer (kornia_tpu_torch.parallel) on ranks spawned by
   parallel.mesh.spawn: (a) 1 rank over NCCL, (b) 4 ranks that share the
   card over gloo (NCCL refuses two ranks of one communicator on one
   card). Each: the sharded front end on the first 4 slam frames
   (OrbConfig(); K1/K2/K3 1/2/1 a frame on every rank, each call recorded
   and held to its plain version, the features bit-equal to the single
   process's); the exchange of the Dense configuration's keyframe layout
   in a2a and rounds mode and, on 4 ranks, a hot pair of 1,500
   observations (every shard's rows equal to host_receive_order;
   payload bytes printed); the summed Schur BA on the Dense (170 × 3000,
   chol) and, on 4 ranks, the PCG (600 × 8000, cg_dense) configuration in
   both layouts, 12 iterations, Huber 2, against the single-process solve
   at PAR_BA_TOL (the reference's distributed-vs-single bounds), 2
   collectives a LM iteration; PGO on the ring, 2 iterations against the
   single process at PAR_PGO_TOL, and on 4 ranks 15 under the backend
   gates; on 4 ranks MonocularSlam(mesh=) over the 40 slam frames, rank 0
   leading each PGO and global BA through parallel.controller.lead and
   the other ranks in parallel.follow, under the slam gates and the slam
   phase's loop count. Every rank's poses bit-equal. Printed: call ms and
   (one solve of each shape traced on rank 0) device ms and launches a LM
   iteration, collectives and bytes a LM iteration, host syncs a solve
   over NCCL, each run's seconds. A rank that raises, dies or hangs past
   PAR_TIMEOUT fails the phase.

The line before the last is the card's name and power limit, the one
before it a JSON object with one entry per kernel; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import inspect
import io as stdio
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from kornia_tpu_torch import apriltag, augmentations, bow, models
from kornia_tpu_torch import io as kio
from kornia_tpu_torch.features import matching, orb, responses
from kornia_tpu_torch.geometry import camera, icp, liegroup, pnp, stereo
from kornia_tpu_torch.geometry import twoview
from kornia_tpu_torch.geometry.ransac import sample_minimal_sets
from kornia_tpu_torch.features import fast
from kornia_tpu_torch.ops import bayer, canny, color, depth, distance_transform
from kornia_tpu_torch.ops import connected_components as ccl
from kornia_tpu_torch.ops import contours
from kornia_tpu_torch.ops import draw
from kornia_tpu_torch.ops import cuda_kernels as ck
from kornia_tpu_torch.ops import enhance, filters, geometry_utils, histogram
from kornia_tpu_torch.ops import interpolation, optical_flow, preprocess
from kornia_tpu_torch.ops import metrics, morphology, normalize, pyramid
from kornia_tpu_torch.ops import resize, threshold, warp, warp_exact, yuv
from kornia_tpu_torch.ops.filters import gaussian_blur
from kornia_tpu_torch.optim import ba, pgo
from kornia_tpu_torch import parallel
from kornia_tpu_torch.parallel import ba_dist, exchange, frontend_dist
from kornia_tpu_torch.parallel import pgo_dist
from kornia_tpu_torch.slam import evaluate as slam_eval
from kornia_tpu_torch.slam import system as slam

H, W = 480, 752
SEED = 0
REPS = 20
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
# thread-operations a Hopper SM issues per clock outside the tensor cores
# (an FMA counts as one): times the SM count and the maximum SM clock of
# the card, read in main(), they are the operation bounds' peak rates
OPS_PER_SM_CLOCK = {"f32": 128, "int32": 64}
RATES = {}                  # ops per second by type, set in main()
K_EUROC = np.array([[458.654, 0.0, 367.215], [0.0, 457.296, 248.375],
                    [0.0, 0.0, 1.0]])
# radtan k1 k2 p1 p2 k3 of tests/test_geometry.py:71-72
DIST_RADTAN = np.array([-0.28, 0.07, 0.0002, -0.0001, 0.001])
STEREO_BASELINE = 0.11      # m, the EuRoC stereo rig's baseline
STEREO_DEG = (0.4, -0.6, 0.3)
KERNELS = {
    "fast_harris": ("kornia_tpu_torch/ops/csrc/fast_harris.cu",
                    "kornia_tpu/ops/pallas_kernels.py:143"),
    "windows_paired": ("kornia_tpu_torch/ops/csrc/windows_paired.cu",
                       "kornia_tpu/ops/pallas_kernels.py:451"),
    "brief_sample": ("kornia_tpu_torch/ops/csrc/brief_sample.cu",
                     "kornia_tpu/ops/pallas_kernels.py:519"),
    "windows": ("kornia_tpu_torch/ops/csrc/windows.cu",
                "kornia_tpu/ops/pallas_kernels.py:401"),
    "lane_gather": ("kornia_tpu_torch/ops/csrc/lane_gather.cu",
                    "kornia_tpu/ops/pallas_kernels.py:327"),
    "preprocess": ("kornia_tpu_torch/ops/csrc/preprocess.cu",
                   "kornia_tpu/ops/pallas_kernels.py:59"),
    "remap": ("kornia_tpu_torch/ops/csrc/remap.cu",
              "kornia_tpu/ops/warp_pallas.py:87"),
    "lane_shift": ("kornia_tpu_torch/ops/csrc/lane_shift.cu",
                   "kornia_tpu/ops/warp_pallas.py:835"),
    "shear_x": ("kornia_tpu_torch/ops/csrc/shear_x.cu",
                "kornia_tpu/ops/warp_shear.py:53"),
    "shear_y": ("kornia_tpu_torch/ops/csrc/shear_x.cu",
                "kornia_tpu/ops/warp_shear.py:53"),
}
HW_1080P = (1080, 1920)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# max |kernel − plain| allowed: 0 (bit-equal) unless named here. K6's plain
# version sums its dense float32 products in cuBLAS's order.
PLAIN_TOL = {"preprocess": 2e-6}
DEV = torch.device("cuda")
# the fast_detector path of the tenth slice
FAST_THRESHOLD = 20.0
FAST_MAX_KP = 2048
ROI_SHARE = 0.6


def log(*args):
    print(*args, flush=True)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def card() -> str:
    return smi("name,power.limit")


def issue_rates():
    """(SMs, max SM clock in MHz): the f32 and int32 issue rates of the
    card into RATES."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(smi("clocks.max.sm").split()[0])
    for kind, per in OPS_PER_SM_CLOCK.items():
        RATES[kind] = per * sms * mhz * 1e6
    return sms, mhz


def cuda_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """The call time of ``fn`` in ms: what one caller waits for one call
    (CUDA events around each single call, median). For a kernel of a few
    microseconds this is the Python wrapper and the launch latency, not
    the kernel: :func:`device_ms` reads that."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = REPS, warmup: int = 3,
              cuda_only: bool = False, out: dict | None = None) -> float:
    """The device time of ``fn`` in ms per call: the summed device time of
    every kernel and device copy it launches, from torch.profiler over
    ``reps`` back-to-back calls. It reads a hand kernel, its plain version
    and a library call alike. Inputs under 50 MB stay in L2 between the
    calls. ``fn`` must enqueue the same work each call.

    The tracer loses the device records of a trace's first launches (1
    to 6 of them, on the H100 machine), so a trace opens with calls
    that are not read: a few milliseconds of them, counted. The host's
    records of what it enqueued (``cudaLaunchKernel``,
    ``cudaMemcpyAsync``, ...) must divide evenly among all the calls; the
    last ``reps`` calls' share of them are the ones read, and each must
    have its device record (same correlation id). Else the trace is taken
    again with more calls before and more quiet around it, and the
    function fails if no trace is complete. ``cuda_only``: trace only
    CUPTI's records (the enqueue calls and the device work; no ATen op
    events), which a solve of tens of thousands of small ops needs to be
    read in seconds rather than minutes. ``out``, a dict, receives the
    launches and copies one call enqueues under "launches"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    acts = ([ProfilerActivity.CUDA] if cuda_only
            else [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    for pad in (0.005, 0.02, 0.1):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            time.sleep(pad)
            fn()
            calls = 1
            until = time.perf_counter() + pad
            while time.perf_counter() < until:
                fn()
                calls += 1
            for _ in range(reps):
                fn()
            calls += reps
            torch.cuda.synchronize()
            time.sleep(pad)
        events = prof.events()
        enqueued = sorted((e for e in events
                           if e.device_type == DeviceType.CPU
                           and e.name.startswith(_ENQUEUES)),
                          key=lambda e: e.time_range.start)
        on_device = {e.id: e for e in events
                     if e.device_type == DeviceType.CUDA}
        if not enqueued:
            # the host records every enqueue: none means no device work
            # (a view); only device records go missing
            if out is not None:
                out["launches"] = 0
            return 0.0
        per_call, rest = divmod(len(enqueued), calls)
        read = enqueued[(calls - reps) * per_call:]
        TRACE_STATS["traces"] += 1
        TRACE_STATS["lost"] += len(enqueued) - len(on_device)
        if per_call and not rest and all(e.id in on_device for e in read):
            if out is not None:
                out["launches"] = per_call
            return sum(on_device[e.id].time_range.elapsed_us()
                       for e in read) / reps / 1e3
        TRACE_STATS["again"] += 1
        log(f"device_ms: {len(enqueued)} launches and copies enqueued in "
            f"{calls} calls, {len(on_device)} device records, "
            f"{sum(e.id not in on_device for e in read)} of the "
            f"{len(read)} that are read missing; measuring again")
    raise AssertionError("device_ms: no profiler trace held every device "
                         "record of the calls that are read")


# the host-side records of work enqueued to the device, by prefix
_ENQUEUES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset",
             "cuMemcpy", "cuMemset")
# device_ms traces; those that had to be taken again; device records lost
# in all (of calls that are not read, unless the trace was taken again)
TRACE_STATS = {"traces": 0, "again": 0, "lost": 0}


def host_us(fn, calls: int = 1000) -> float:
    """Host microseconds per call: ``calls`` calls of ``fn`` without a
    synchronise. Where the kernel outlasts its enqueue the launch queue
    fills and this reads the kernel."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e6 / calls


def kernel_times(kernel, plain, library=None) -> dict:
    """Device and call times of a kernel wrapper, its plain version and
    its library call; ``ms`` and ``library_ms`` are the call times under
    the names the earlier rows used."""
    row = {"device_ms": device_ms(kernel), "call_ms": cuda_ms(kernel),
           "host_us": host_us(kernel),
           "plain_device_ms": device_ms(plain), "plain_ms": cuda_ms(plain),
           "library_device_ms": None, "library_call_ms": None}
    if library is not None:
        row["library_device_ms"] = device_ms(library)
        row["library_call_ms"] = cuda_ms(library)
    row["ms"] = row["call_ms"]
    row["library_ms"] = row["library_call_ms"]
    return row


def fmt_times(row: dict, library: str = "library") -> str:
    text = (f"kernel device {row['device_ms']:.4f} ms / call "
            f"{row['call_ms']:.4f} ms (host {row['host_us']:.1f} us per "
            f"call), plain device {row['plain_device_ms']:.4f} / call "
            f"{row['plain_ms']:.4f} ms")
    if row["library_call_ms"] is None:
        return text + f", {library} none"
    return (text + f", {library} device {row['library_device_ms']:.4f} / "
            f"call {row['library_call_ms']:.4f} ms")


TIME_KEYS = ("device_ms", "call_ms", "host_us", "ms", "plain_ms",
             "plain_device_ms", "library_device_ms", "library_call_ms",
             "library_ms")
# times of the route a redesign replaced, taken in the same run: "before"
# with this tree's code, "parent" with the parent tree's kernels (--parent)
BEFORE_KEYS = ("before_device_ms", "before_call_ms", "parent_device_ms",
               "parent_call_ms", "parent_chain_device_ms",
               "parent_chain_call_ms")
# K5's broadcast case: torch.gather on the expanded index beside the
# stride-0 one; every row: host us per call in turns (this tree's and, with
# --parent, the parent's wrapper)
EXTRA_KEYS = ("library2_device_ms", "library2_call_ms", "host_us_turns")
# per wrapper, one call on the main path's recorded inputs through a
# kernel module (this tree's ``ck`` or the parent's): name -> fn(module)
HOST_CASES = {}


# --------------------------------------------------------------------------
# scene
# --------------------------------------------------------------------------


def _texture(rng, n: int = 320, up: int = 8) -> np.ndarray:
    """Seeded noise upsampled ×``up`` bilinearly, float64 in [0, 255]."""
    small = rng.random((n + 1, n + 1)) * 255.0
    f = (np.arange(n * up) + 0.5) / up - 0.5
    i0 = np.clip(np.floor(f).astype(int), 0, n - 1)
    a = np.clip(f - i0, 0.0, 1.0)
    rows = small[i0] * (1 - a)[:, None] + small[i0 + 1] * a[:, None]
    return rows[:, i0] * (1 - a)[None] + rows[:, i0 + 1] * a[None]


def _bilinear(tex: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    n = tex.shape[0]
    u = np.clip(u, 0, n - 1.001)
    v = np.clip(v, 0, n - 1.001)
    u0, v0 = np.floor(u).astype(int), np.floor(v).astype(int)
    du, dv = u - u0, v - v0
    return (tex[v0, u0] * (1 - du) * (1 - dv) + tex[v0, u0 + 1] * du * (1 - dv)
            + tex[v0 + 1, u0] * (1 - du) * dv
            + tex[v0 + 1, u0 + 1] * du * dv)


_PLANES = [(np.array([1.0, 0.0, 1.0]), 5.0),    # X > 0 side
           (np.array([-1.0, 0.0, 1.0]), 5.0)]   # X < 0 side


def _rot_xyz(deg) -> np.ndarray:
    """Rz·Ry·Rx of the three angles in degrees."""
    ang = np.deg2rad(deg)
    cx, cy, cz = np.cos(ang)
    sx, sy, sz = np.sin(ang)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rz @ ry @ rx


def _view(pix, rot, origin, texs):
    """Ray-cast the two textured planes: ``pix`` (H, W, 3) camera rays,
    camera = rot·(X − origin)."""
    d = pix @ rot          # world ray directions, rows: Rᵀ·dir
    best = np.full((H, W), np.inf)
    img = np.zeros((H, W))
    for (n, off), tex in zip(_PLANES, texs):
        s = (off - origin @ n) / (d @ n)
        s = np.where(s > 0, s, np.inf)
        p = origin + s[..., None] * d
        val = _bilinear(tex, (p[..., 0] + 6.0) * 200.0,
                        (p[..., 1] + 6.0) * 200.0)
        take = s < best
        img = np.where(take, val, img)
        best = np.minimum(best, s)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def _hit(xy, rot, origin):
    """(N, 3) world points where the rays of pixels ``xy`` (N, 2) of the
    camera rot·(X − origin) first meet the two planes: the ray-cast of
    :func:`_view`, per ray."""
    d = (np.concatenate([xy, np.ones_like(xy[:, :1])], -1)
         @ np.linalg.inv(K_EUROC).T) @ rot
    s = np.full(len(xy), np.inf)
    for n, off in _PLANES:
        si = (off - origin @ n) / (d @ n)
        s = np.minimum(s, np.where(si > 0, si, np.inf))
    return origin + s[:, None] * d


# (rotation, centre) of the scene's views, camera = R·(X − centre); view
# 1 is the world frame
VIEW2 = (_rot_xyz([1.0, -2.0, 0.5]), np.array([0.3, 0.05, 0.02]))
VIEW3 = (_rot_xyz([-1.5, 1.5, -0.5]), np.array([-0.2, 0.1, 0.1]))


def scene_textures(seed: int = SEED):
    rng = np.random.default_rng(seed)
    return [_texture(rng), _texture(rng)]


def render_view(rot, origin, texs) -> np.ndarray:
    """One 480×752 u8 view of the scene, camera rot·(X − origin)."""
    vv, uu = np.mgrid[0:H, 0:W].astype(np.float64)
    pix = np.stack([uu, vv, np.ones_like(uu)], -1) @ np.linalg.inv(
        K_EUROC).T                                             # (H, W, 3)
    return _view(pix, rot, origin, texs)


def render_scene(seed: int = SEED):
    """Two views of a 'roof' of two textured planes z = 5 ∓ X (they meet
    at X = 0), camera 2 = R·X + t. Returns (img1, img2, R, t)."""
    r, center2 = VIEW2
    t = -r @ center2
    texs = scene_textures(seed)
    img1 = render_view(np.eye(3), np.zeros(3), texs)
    img2 = render_view(r, center2, texs)
    return img1, img2, r, t / np.linalg.norm(t)


def _undistort_normalized(xd, yd, dist, iters: int = 200):
    """Invert radtan distortion by fixed-point iteration in float64; returns
    (x, y) and the largest residual of the distortion model."""
    k1, k2, p1, p2, k3 = dist
    x, y = xd.copy(), yd.copy()

    def distort(x, y):
        r2 = x * x + y * y
        rad = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 ** 3
        return (x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x),
                y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y)

    for _ in range(iters):
        dx, dy = distort(x, y)
        x, y = xd - (dx - x), yd - (dy - y)
    dx, dy = distort(x, y)
    return x, y, float(max(np.abs(dx - xd).max(), np.abs(dy - yd).max()))


def render_stereo(seed: int = SEED):
    """A raw EuRoC-size stereo pair of the same scene: camera 2 is moved
    STEREO_BASELINE m along x and turned by STEREO_DEG (each ≤ 1°), and
    both views are distorted by K_EUROC and DIST_RADTAN (each pixel sees
    the ray of its undistorted position). Returns (img1, img2, R, t) with
    cam2 = R·cam1 + t."""
    rng = np.random.default_rng(seed)
    texs = [_texture(rng), _texture(rng)]
    r = _rot_xyz(STEREO_DEG)
    center2 = np.array([STEREO_BASELINE, 0.0, 0.0])
    vv, uu = np.mgrid[0:H, 0:W].astype(np.float64)
    xd = (uu - K_EUROC[0, 2]) / K_EUROC[0, 0]
    yd = (vv - K_EUROC[1, 2]) / K_EUROC[1, 1]
    x, y, resid = _undistort_normalized(xd, yd, DIST_RADTAN)
    if resid > 1e-9:
        raise AssertionError(f"distortion inverse did not converge: {resid}")
    pix = np.stack([x, y, np.ones_like(x)], -1)
    img1 = _view(pix, np.eye(3), np.zeros(3), texs)
    img2 = _view(pix, r, center2, texs)
    return img1, img2, r, -r @ center2


def chord_rad(r_a, r_b) -> float:
    """The angle between two rotations from the Frobenius chord: stable
    for the small angles an arccos of the trace loses in float32 rounding."""
    d = np.linalg.norm(np.asarray(r_a, np.float64) - np.asarray(r_b,
                                                                np.float64))
    return float(2 * np.arcsin(min(d / (2 * np.sqrt(2)), 1.0)))


def rot_err_deg(r_est, r_gt) -> float:
    c = (np.trace(r_est.T @ r_gt) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(c, -1, 1))))


def dir_err_deg(t_est, t_gt) -> float:
    c = abs(np.dot(t_est / np.linalg.norm(t_est), t_gt))
    return float(np.degrees(np.arccos(np.clip(c, -1, 1))))


# --------------------------------------------------------------------------
# the slice
# --------------------------------------------------------------------------


def run_pair(img1, img2, device, generator=None):
    cfg = orb.OrbConfig()
    f1 = orb.orb_detect_and_describe(img1, cfg, device=device)
    f2 = orb.orb_detect_and_describe(img2, cfg, device=device)
    m = matching.match_descriptors(f1.descriptors, f2.descriptors,
                                   a_mask=f1.mask, b_mask=f2.mask,
                                   max_distance=64, ratio=0.8,
                                   device=device)
    x1, x2, mk = matching.matched_points(f1.xy, f2.xy, m)
    res = None
    if device != "cpu":
        res = twoview.estimate_relative_pose(
            x1, x2, K_EUROC, K_EUROC, mask=mk,
            params=twoview.TwoViewParams(), generator=generator,
            device=device)
    return f1, f2, m, res


def device_share(label, fn, card_line, cuda_only: bool = False):
    """``fn`` once under torch.profiler: the device's busy share of the
    host wall time, the number of kernels launched and the kernels that
    take the most device time (``cuda_only``: as in :func:`device_ms`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA] if cuda_only else
                 [ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    n = sum(e.count for e in kern)
    if not kern:
        log("profile: no device time in the trace: device busy share not "
            "measured")
        return None
    log(f"profile {label}: wall {wall_ms:.3f} ms (profiled), device busy "
        f"{busy_ms:.3f} ms = {busy_ms / wall_ms:.4f} of wall, {n} kernel "
        f"launches [{card_line}]")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms, "launches": n}


# --------------------------------------------------------------------------
# the warping slice: rectify, warp, lane_shift, shear
# --------------------------------------------------------------------------


def bound(nbytes, int_ops=0, f32_ops=0):
    """(least ms, what bounds it): the bytes at the published memory rate,
    or the integer and the f32 operations at their issue rates (two pipes
    that run side by side, so the slower of the two), whichever is
    longer."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = max(int_ops / RATES["int32"], f32_ops / RATES["f32"]) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


class Record:
    """Record the arguments (``calls``) and results (``outs``) of every
    call of one function of ``mod`` (a kernel wrapper of cuda_kernels by
    default) while the block runs; the calls themselves go through."""

    def __init__(self, name: str, mod=ck):
        self.name = name
        self.mod = mod
        self.calls = []
        self.outs = []

    def __enter__(self):
        self.orig = getattr(self.mod, self.name)

        def rec(*args, **kwargs):
            self.calls.append((args, kwargs))
            self.outs.append(self.orig(*args, **kwargs))
            return self.outs[-1]

        setattr(self.mod, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)


def brief_index_form(windows, angle, seed=7, pattern="rublee2011",
                     brief="sample"):
    """BRIEF bits by the index form that ``brief_rotated`` replaced on the
    path: ``_brief_tap_coords`` (about twenty PyTorch ops), the
    ``brief_sample`` kernel on (K, T) int32 rows and cols, and the compare.
    (K/2, 40, 128) windows are the paired layout, (K, 48, 128) the
    unpaired one. Returns (bits, samples)."""
    k = angle.shape[0]
    if windows.shape[1] == ck.PAIR_WIN_H:
        rows, cols = orb._brief_tap_coords(angle, seed, pattern, half_w=32)
        rows = rows.reshape(k // 2, 1024).contiguous()
        lane = torch.tensor([0, 64], dtype=torch.int32, device=angle.device)
        cols = (cols.reshape(k // 2, 2, 512)
                + lane[None, :, None]).reshape(k // 2, 1024).contiguous()
    else:
        rows, cols = orb._brief_tap_coords(angle, seed, pattern)
        rows, cols = rows.contiguous(), cols.contiguous()
    s = ck.brief_sample(windows.contiguous(), rows, cols).reshape(k, 512)
    return (s[:, :256] < s[:, 256:]).to(torch.uint8), s


class IndexFormBrief:
    """While the block runs, ORB describes through :func:`brief_index_form`
    (the path before ``brief_rotated``), for a before/after stage time in
    one run."""

    def __enter__(self):
        self.saved = (orb.brief_from_windows_paired, orb.brief_from_windows)
        orb.brief_from_windows_paired = \
            lambda *a, **kw: brief_index_form(*a, **kw)[0]
        orb.brief_from_windows = \
            lambda *a, **kw: brief_index_form(*a, **kw)[0]

    def __exit__(self, *exc):
        orb.brief_from_windows_paired, orb.brief_from_windows = self.saved


def check_brief_calls(calls, label):
    """Every recorded ``brief_from_windows(_paired)`` call: the path's
    bits (through ``brief_rotated``) equal the index form's on the same
    windows and angles, and kernel and plain version agree in bits and
    samples. Returns the number of descriptor bits compared."""
    n = 0
    for args, kwargs in calls:
        if kwargs.get("brief", "sample") != "sample" or \
                (len(args) > 4 and args[4] != "sample"):
            continue
        windows, angle = args[0].contiguous(), args[1]
        seed = args[2] if len(args) > 2 else kwargs.get("seed", 7)
        pattern = args[3] if len(args) > 3 else kwargs.get("pattern",
                                                           "rublee2011")
        layout = ("paired" if windows.shape[1] == ck.PAIR_WIN_H
                  else "unpaired")
        rot = (windows, torch.cos(angle), torch.sin(angle),
               orb._pattern_on(pattern, seed, angle.device), layout)
        bits = ck.brief_rotated(*rot)
        samples = ck.brief_rotated(*rot, out="samples")
        old_bits, old_samples = brief_index_form(windows, angle, seed,
                                                 pattern)
        if not (torch.equal(bits, old_bits)
                and torch.equal(samples, old_samples)
                and torch.equal(bits, ck._brief_rotated_plain(*rot))
                and torch.equal(samples, ck._brief_rotated_plain(
                    *rot, out="samples"))):
            raise AssertionError(f"brief_rotated ({label}, {layout}, "
                                 f"{tuple(windows.shape)}) differs from the "
                                 "index form or its plain version")
        n += bits.numel()
    return n


def counted(fn):
    """Run ``fn`` with every launch count set to 0 just before; returns
    (result, the counts just after)."""
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(ck.LAUNCHES)


def only(launches, want):
    full = {name: 0 for name in ck.LAUNCHES}
    full.update(want)
    if launches != full:
        raise AssertionError(f"launch counts {launches} != {full}")


class PerLevelK1:
    """While the block runs, ORB takes K1's maps from one launch per level
    (the route before ``fast_harris_levels``)."""

    def __enter__(self):
        self.saved = ck.fast_harris_levels
        ck.fast_harris_levels = lambda levels, thr: [
            self.saved([lv], thr)[0] for lv in levels]

    def __exit__(self, *exc):
        ck.fast_harris_levels = self.saved


def load_parent(root: str):
    """The parent tree's kernel wrappers, for before/after times in one
    run: ``root``'s own ``kornia_tpu_torch/ops/cuda_kernels.py`` loaded
    under another module name, with every kernel built from ``root``'s
    sources into ``root``'s build directory."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "parent_cuda_kernels",
        os.path.join(root, "kornia_tpu_torch", "ops", "cuda_kernels.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.build()
    return mod


def in_turns(new, old):
    """Device and call ms of two functions on one machine, taken in the
    order old, new, new, old: ({"device": [..], "call": [..]} of new, the
    same of old), each list in the order taken."""
    t = {"new": {"device": [], "call": []}, "old": {"device": [], "call": []}}
    for which in ("old", "new", "new", "old"):
        fn = new if which == "new" else old
        t[which]["device"].append(device_ms(fn))
        t[which]["call"].append(cuda_ms(fn))
    return t["new"], t["old"]


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def _grid(sx: torch.Tensor, sy: torch.Tensor, h: int, w: int):
    """Pixel coordinates → grid_sample's align_corners=True grid."""
    return torch.stack([sx * (2.0 / (w - 1)) - 1.0,
                        sy * (2.0 / (h - 1)) - 1.0], -1)[None]


def remap_case(args, kwargs):
    """K7 on one recorded call: kernel vs plain, times, library time, bound.
    Returns a dict for the kernels line."""
    img, out_hw, form = args
    k_out = ck.remap(*args, **kwargs)
    p_out = ck._remap_plain(*args, **kwargs)
    torch.cuda.synchronize()
    err = max_err(k_out, p_out)
    if err != 0.0:
        raise AssertionError(f"remap ({form}) differs from its plain "
                             f"version: {err}")
    h, w, c = img.shape
    sx, sy = ck._source_coords(form, out_hw, kwargs.get("coefs"),
                               kwargs.get("map_x"), kwargs.get("map_y"),
                               img.device)
    if kwargs.get("border"):
        sx = sx.clamp(0.0, w - 1.0)
        sy = sy.clamp(0.0, h - 1.0)
    nearest = kwargs.get("nearest", False)
    if nearest:
        sx, sy = torch.floor(sx + 0.5), torch.floor(sy + 0.5)
    # source values the function needs, each once: the taps with weight
    # (one for nearest, four for bilinear) that land in the image
    x0, y0 = torch.floor(sx).long(), torch.floor(sy).long()
    touched = torch.zeros(h * w, dtype=torch.bool, device=img.device)
    for dy, dx in ((0, 0),) if nearest else ((0, 0), (0, 1), (1, 0), (1, 1)):
        ix, iy = x0 + dx, y0 + dy
        ok = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        touched[(iy * w + ix)[ok]] = True
    esize = img.element_size()
    nbytes = (int(touched.sum()) * c * esize + k_out.numel() * esize
              + (sx.numel() * 8 if form == "data" else 0))
    bms, by = bound(nbytes)
    lib_in = img.permute(2, 0, 1)[None].float().contiguous()
    grid = _grid(sx, sy, h, w)
    pad = "border" if kwargs.get("border") else "zeros"
    mode = "nearest" if nearest else "bilinear"

    def lib():
        return torch.nn.functional.grid_sample(
            lib_in, grid, mode=mode, padding_mode=pad, align_corners=True)

    def lib_whole():
        """grid_sample as a caller with an HWC image would run it: to f32
        NCHW, sample, back to HWC in the image's type."""
        o = torch.nn.functional.grid_sample(
            img.permute(2, 0, 1)[None].float(), grid, mode=mode,
            padding_mode=pad, align_corners=True)[0].permute(1, 2, 0)
        if img.dtype == torch.uint8:
            return o.round().clamp(0, 255).to(torch.uint8)
        return o.contiguous()

    lib_dev = float((lib()[0].permute(1, 2, 0) - p_out.float()).abs().mean())
    row = {"launches": 1, "max_abs_err": err, "bound_ms": bms,
           "bound_by": by, "bytes": nbytes, "library_mean_abs_dev": lib_dev,
           "library_whole_device_ms": device_ms(lib_whole),
           "library_whole_call_ms": cuda_ms(lib_whole)}
    row.update(kernel_times(lambda: ck.remap(*args, **kwargs),
                            lambda: ck._remap_plain(*args, **kwargs), lib))
    return row


def fmt_remap(row: dict) -> str:
    return (f"{fmt_times(row, 'grid_sample on ready f32 NCHW')} (mean |dev| "
            f"{row['library_mean_abs_dev']:.4f}; with the conversion from "
            f"and to HWC device {row['library_whole_device_ms']:.4f} / call "
            f"{row['library_whole_call_ms']:.4f} ms), bound "
            f"{row['bound_ms']:.5f} ms ({row['bound_by']}, {row['bytes']} B)")


def phase_rectify(card_line):
    """The slice's path: raw stereo pair → rectify → ORB ×2 → match."""
    img1, img2, r, t = render_stereo()
    rect = stereo.StereoRectifier.from_calib(
        K_EUROC, DIST_RADTAN, K_EUROC, DIST_RADTAN, (H, W), r, t)
    raw1 = torch.as_tensor(img1, device=DEV)
    raw2 = torch.as_tensor(img2, device=DEV)
    cfg = orb.OrbConfig()

    def rectify():
        return (rect.rectify_left(raw1, device=DEV),
                rect.rectify_right(raw2, device=DEV))

    def path():
        g1, g2 = rectify()
        f1 = orb.orb_detect_and_describe(g1, cfg, device=DEV)
        f2 = orb.orb_detect_and_describe(g2, cfg, device=DEV)
        m = matching.match_descriptors(
            f1.descriptors, f2.descriptors, a_mask=f1.mask, b_mask=f2.mask,
            max_distance=64, ratio=0.8, device=DEV)
        return g1, g2, f1, f2, m

    path()                                          # warm-up
    (g1, g2, f1, f2, m), launches = counted(path)
    log(f"rectify path launches: {launches}")
    only(launches, {"remap": 2, "fast_harris": 2, "windows_paired": 4,
                    "brief_rotated": 2})
    x1, x2, mk = matching.matched_points(f1.xy, f2.xy, m)
    dy = (x1[:, 1] - x2[:, 1]).abs()[mk].double()
    disp = (x1[:, 0] - x2[:, 0])[mk].double()
    if dy.numel() < 100:
        raise AssertionError(f"only {dy.numel()} matches after rectify")
    med, p95 = float(dy.median()), float(torch.quantile(dy, 0.95))
    log(f"rectify: baseline {rect.baseline:.6f} m, bf {rect.bf:.4f}; "
        f"{dy.numel()} matches, |y1 - y2| median {med:.4f} px, p95 "
        f"{p95:.4f} px; disparity median {float(disp.median()):.4f} px")
    if not med < 0.5:
        raise AssertionError("rectified rows disagree: median |y1 - y2| "
                             f"{med} >= 0.5 px")
    for g in (g1, g2):
        if g.dtype != torch.uint8 or tuple(g.shape) != (H, W):
            raise AssertionError("rectified image shape/dtype")

    with Record("remap") as rec:
        rectify()
    cases = [remap_case(a, kw) for a, kw in rec.calls]
    a7, kw7 = rec.calls[0]
    HOST_CASES["remap"] = lambda mod: mod.remap(*a7, **kw7)
    row = dict(cases[0])
    row["max_abs_err"] = max(c["max_abs_err"] for c in cases)
    row["launches"] = launches["remap"]
    log(f"K7 remap on the rectify path ({H}x{W} u8, data maps): bit-equal "
        f"on both views; {fmt_remap(row)} [{card_line}]")

    def stage(name, fn):
        log(f"stage {name}: {cuda_ms(fn):.3f} ms [{card_line}]")

    stage("rectify left+right", rectify)
    stage("orb_detect_and_describe x2 (rectified)", lambda: [
        orb.orb_detect_and_describe(g, cfg, device=DEV) for g in (g1, g2)])
    stage("match_descriptors (rectified)", lambda: matching.match_descriptors(
        f1.descriptors, f2.descriptors, a_mask=f1.mask, b_mask=f2.mask,
        max_distance=64, ratio=0.8, device=DEV))
    stage("whole rectify path", path)
    device_share("whole rectify path", path, card_line)
    return row


def phase_warp(card_line):
    """K7 at the reference's audit size, 1080×1920×3 u8."""
    hh, ww = HW_1080P
    img = np.random.default_rng(SEED + 1).integers(0, 256, (hh, ww, 3),
                                                   np.uint8)
    x = torch.as_tensor(img, device=DEV)
    ctr = (ww / 2, hh / 2)
    k1080 = K_EUROC * np.array([[ww / W], [hh / H], [1.0]])
    hom = np.array([[1.0, 0.05, -20.0], [0.02, 0.98, 15.0],
                    [2e-5, -1.5e-5, 1.0]], np.float32)
    mx, my = camera.generate_correction_map_polynomial(
        k1080, DIST_RADTAN, HW_1080P, device=DEV)
    cases = [
        ("warp_affine rot10", lambda: warp.warp_affine(
            x, warp.get_rotation_matrix2d(ctr, 10.0, 1.0, device=DEV),
            HW_1080P, device=DEV)),
        ("warp_affine rot30", lambda: warp.warp_affine(
            x, warp.get_rotation_matrix2d(ctr, 30.0, 1.0, device=DEV),
            HW_1080P, device=DEV)),
        ("warp_affine scale0.5", lambda: warp.warp_affine(
            x, np.array([[0.5, 0.0, ww / 4], [0.0, 0.5, hh / 4]]), HW_1080P,
            device=DEV)),
        ("warp_perspective", lambda: warp.warp_perspective(
            x, hom, HW_1080P, device=DEV)),
        ("undistort_image", lambda: camera.undistort_image(
            x, k1080, DIST_RADTAN, device=DEV)),
    ] + [(f"remap {mode} {pad}",
          lambda mode=mode, pad=pad: interpolation.remap(
              x, mx, my, mode=mode, padding_mode=pad, device=DEV))
         for mode in ("bilinear", "nearest") for pad in ("zeros", "border")]
    # a matrix made on the card: the entry point must not wait for the
    # device (the inverse map is computed there and the kernel reads the
    # coefficients from device memory); the same matrix from the host
    # goes by value
    m_card = warp.get_rotation_matrix2d(ctr, 10.0, 1.0, device=DEV)
    m_host = m_card.cpu()
    c_card = warp_exact.affine_coefs(m_card)
    if not (c_card.is_cuda and torch.equal(
            c_card.cpu(), warp_exact.affine_coefs(m_host))):
        raise AssertionError("affine coefficients computed on the card "
                             "differ from the host's")

    def from_card():
        return warp.warp_affine(x, m_card, HW_1080P, device=DEV)

    def from_host():
        return warp.warp_affine(x, m_host, HW_1080P, device=DEV)

    from_card()                                     # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out_card, launches = counted(from_card)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    only(launches, {"remap": 1})
    if not torch.equal(out_card, from_host()):
        raise AssertionError("warp_affine with a card-made matrix differs "
                             "from the host-matrix call")
    def by_copy():
        """The route before: the card's matrix copied to the host (which
        waits for the device), inverted there."""
        return warp.warp_affine(x, m_card.cpu(), HW_1080P, device=DEV)

    log(f"warp_affine rot10 with a matrix made on the card ran under "
        f"torch.cuda.set_sync_debug_mode('error'): no wait for the device, "
        f"coefficients and image bit-equal to the host-matrix call; entry "
        f"point call {cuda_ms(from_card):.4f} ms (host "
        f"{host_us(from_card):.1f} us); the same matrix first copied to "
        f"the host, as before: {cuda_ms(by_copy):.4f} ms (host "
        f"{host_us(by_copy):.1f} us); a matrix that is on the host already: "
        f"{cuda_ms(from_host):.4f} ms (host {host_us(from_host):.1f} us) "
        f"[{card_line}]")
    # the traffic the card route is for: frame after frame, a matrix that
    # comes out of device work still in the queue (a tracker's estimate).
    # The copy route waits for that work on every frame, the card route
    # lets the host run ahead.
    for size in (0, 2048, 4096):
        a = torch.randn(max(size, 1), max(size, 1), device=DEV)
        work_ms = cuda_ms(lambda: a @ a) if size else 0.0

        def frames(route, n=50):
            for _ in range(n):
                m = m_card + (a @ a)[0, 0] * 0.0 if size else m_card
                out = route(m)
            return out

        def per_frame(route):
            frames(route, 5)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = frames(route)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / 50, out

        on_card, o1 = per_frame(
            lambda m: warp.warp_affine(x, m, HW_1080P, device=DEV))
        copied, o2 = per_frame(
            lambda m: warp.warp_affine(x, m.cpu(), HW_1080P, device=DEV))
        if not (torch.equal(o1, out_card) and torch.equal(o2, out_card)):
            raise AssertionError("pipelined warp_affine differs")
        log(f"warp_affine pipeline, 50 frames, {work_ms:.3f} ms of queued "
            f"device work ({size}x{size} f32 product) before each matrix: "
            f"matrix left on the card {on_card:.4f} ms per frame, copied "
            f"to the host first {copied:.4f} ms per frame [{card_line}]")
    hom_card = torch.as_tensor(hom, device=DEV)
    c_h = torch.linalg.inv(torch.as_tensor(hom)).reshape(9)
    c_c = torch.linalg.inv_ex(hom_card).inverse.reshape(9).cpu()
    ulp = int((c_c.view(torch.int32) - c_h.view(torch.int32)).abs().max())
    if not torch.equal(
            warp.warp_perspective(x, hom_card, HW_1080P, device=DEV),
            ck._remap_plain(x, HW_1080P, "persp", coefs=c_c.to(DEV))):
        raise AssertionError("warp_perspective with a card-made homography "
                             "differs from the plain version on its own "
                             "coefficients")
    log(f"warp_perspective with the homography on the card: inverse on the "
        f"card at most {ulp} ULP from the host's in the nine coefficients; "
        f"bit-equal to the plain version on the same coefficients")

    rows = []
    for name, fn in cases:
        out, launches = counted(fn)
        only(launches, {"remap": 1})
        if out.dtype != torch.uint8 or tuple(out.shape) != (hh, ww, 3):
            raise AssertionError(f"{name}: output {out.dtype} {out.shape}")
        with Record("remap") as rec:
            fn()
        row = remap_case(*rec.calls[0])
        row["case"] = name
        stage_ms = cuda_ms(fn)
        log(f"K7 {name} ({hh}x{ww}x3 u8): launches 1, bit-equal; "
            f"{fmt_remap(row)}; entry point {stage_ms:.4f} ms [{card_line}]")
        rows.append(row)
    return rows


def _sheared_branch_shifts(m: torch.Tensor, s: int):
    """The pre-shear slope, s0 and per-row shifts that the JAX package's
    sheared branch computes for an affine warp whose central row rate picks
    rot90 case 0 (warp_pallas.py:927-986): κ = −d/a of the inverse map,
    clipped to ±1.05 and quantised to 2^-20."""
    c = warp_exact.affine_coefs(m)
    if not (c[4] >= c[1].abs() and c[4] > 0):
        raise AssertionError("lane_shift phase expects rot90 case 0")
    kappa = torch.clamp(-c[3] / c[0], -1.05, 1.05)
    kappa = torch.round(kappa * 2.0 ** 20) * 2.0 ** -20
    s0 = torch.minimum(torch.floor(kappa * 0.0),
                       torch.floor(kappa * float(s - 1)))
    shift = torch.floor(kappa * torch.arange(s, dtype=torch.float32)) - s0
    return shift.to(torch.int32)


def lane_shift_inputs():
    """K8's inputs at the 1080p 30° sheared-branch shapes, 3 channels: the
    (3, s, s) source, the (s,) int32 shifts and the output width."""
    hh, ww = HW_1080P
    s = max(hh, ww)
    ht = s + int(np.ceil(1.05 * s)) + 8
    img = np.random.default_rng(SEED + 2).integers(0, 256, (hh, ww, 3),
                                                   np.uint8)
    m = warp.get_rotation_matrix2d((ww / 2, hh / 2), 30.0, 1.0, device="cpu")
    shift = _sheared_branch_shifts(m, s).to(DEV)
    # rot90 case 0: the transposed content, zero-padded to the s × s canvas
    xt = torch.as_tensor(img, device=DEV).float().permute(2, 1, 0)
    src = torch.nn.functional.pad(xt, (0, s - hh, 0, s - ww)).contiguous()
    return src, shift, ht


def phase_lane_shift(card_line, parent=None):
    """K8 at the 1080p 30° sheared-branch shapes, 3 channels."""
    src, shift, ht = lane_shift_inputs()
    s = src.shape[-1]
    out, launches = counted(lambda: warp_exact.lane_shift(src, shift, ht,
                                                          device=DEV))
    only(launches, {"lane_shift": 1})
    plain = ck._lane_shift_plain(src, shift, ht)
    err = max_err(out, plain)
    if err != 0.0 or tuple(out.shape) != (3, s, ht):
        raise AssertionError(f"lane_shift differs from its plain version: "
                             f"{err}, {tuple(out.shape)}")
    nbytes = src.numel() * 4 + shift.numel() * 4 + out.numel() * 4
    bms, by = bound(nbytes)
    j = torch.arange(ht, dtype=torch.float32, device=DEV)
    r = torch.arange(s, dtype=torch.float32, device=DEV)
    grid = _grid(j[None, :] - shift.float()[:, None],
                 r[:, None].expand(s, ht), s, s)
    lib_in = src[None]

    def lib():
        return torch.nn.functional.grid_sample(
            lib_in, grid, mode="nearest", padding_mode="zeros",
            align_corners=True)

    dev = float((lib()[0] - plain).abs().mean())
    row = {"launches": launches["lane_shift"], "max_abs_err": err,
           "bound_ms": bms, "bound_by": by}
    row.update(kernel_times(lambda: ck.lane_shift(src, shift, ht),
                            lambda: ck._lane_shift_plain(src, shift, ht),
                            lib))
    log(f"K8 lane_shift (3 x {s} x {s} f32 -> 3 x {s} x {ht}, shifts "
        f"{int(shift.min())}..{int(shift.max())}): launches 1, bit-equal; "
        f"{fmt_times(row, 'grid_sample nearest')} (mean |dev| {dev:.4f}), "
        f"bound {bms:.5f} ms ({by}, {nbytes} B) [{card_line}]")
    if parent is not None:
        if not torch.equal(parent.lane_shift(src, shift, ht), out):
            raise AssertionError("parent lane_shift differs")
        new, old = in_turns(lambda: ck.lane_shift(src, shift, ht),
                            lambda: parent.lane_shift(src, shift, ht))
        row["parent_device_ms"] = old["device"]
        row["parent_call_ms"] = old["call"]
        log(f"K8 in turns (parent, new, new, parent): device new "
            f"{new['device']} parent {old['device']} ms, call new "
            f"{new['call']} parent {old['call']} ms [{card_line}]")
    HOST_CASES["lane_shift"] = lambda mod: mod.lane_shift(src, shift, ht)
    return row


def phase_shear(card_line, parent=None):
    """warp_affine(method="shear") at 1080p RGB, 25°: four K9 row passes
    and two column passes. Returns (shear_x row, shear_y row)."""
    hh, ww = HW_1080P
    img = np.random.default_rng(SEED + 3).integers(0, 256, (hh, ww, 3),
                                                   np.uint8)
    x = torch.as_tensor(img, device=DEV)
    m = warp.get_rotation_matrix2d((ww / 2, hh / 2), 25.0, 1.0, device=DEV)

    def fn():
        return warp.warp_affine(x, m, HW_1080P, method="shear", device=DEV)

    fn()                                            # warm-up
    out, launches = counted(fn)
    only(launches, {"shear_x": 4, "shear_y": 2})
    if out.dtype != torch.uint8 or tuple(out.shape) != (hh, ww, 3):
        raise AssertionError("shear warp output shape/dtype")
    with Record("shear_x") as rec_x, Record("shear_y") as rec_y:
        fn()
    # no canvas copy around a column pass: it reads a row pass's output as
    # it is, and the next row pass reads its output as it is
    x_in = {a[0].data_ptr() for a, _ in rec_x.calls}
    x_out = {o.data_ptr() for o in rec_x.outs}
    for (a, _), o in zip(rec_y.calls, rec_y.outs):
        if a[0].data_ptr() not in x_out or o.data_ptr() not in x_in:
            raise AssertionError("a column pass's canvas was copied")
    errs = {}
    for name, rec, plain in (("shear_x", rec_x, ck._shear_x_plain),
                             ("shear_y", rec_y, ck._shear_y_plain)):
        errs[name] = 0.0
        for (args, kw), got in zip(rec.calls, rec.outs):
            e = max_err(got, plain(*args, **kw))
            if e != 0.0:
                raise AssertionError(f"{name} differs from its plain "
                                     f"version: {e}")
    canvas, shifts = rec_x.calls[0][0]
    canvas_y, shifts_y = rec_y.calls[0][0]
    HOST_CASES["shear_x"] = lambda mod: mod.shear_x(canvas, shifts)
    HOST_CASES["shear_y"] = lambda mod: mod.shear_y(canvas_y, shifts_y)
    b, c, _ = canvas.shape
    nbytes = canvas.numel() * 4 * 2 + shifts.numel() * 4
    bms, by = bound(nbytes)
    xs = torch.arange(c, dtype=torch.float32, device=DEV)
    grids = {
        "shear_x": _grid(xs[None, :] + shifts[:, None],
                         xs[:, None].expand(c, c), c, c),
        "shear_y": _grid(xs[None, :].expand(c, c),
                         xs[:, None] + shifts_y[None, :], c, c)}

    def lib(name, src):
        inp = src[:, None]
        return lambda: torch.nn.functional.grid_sample(
            inp, grids[name].expand(b, c, c, 2), mode="bilinear",
            padding_mode="zeros", align_corners=True)

    def chain(kernel=ck.shear_x):
        """The column pass before: the row pass on the transpose, between
        two transpose copies (the second one made by the next row pass)."""
        return lambda: kernel(canvas_y.transpose(-1, -2).contiguous(),
                              shifts_y).transpose(-1, -2).contiguous()

    rows = {}
    for name, kern, plain, (cv, sh) in (
            ("shear_x", ck.shear_x, ck._shear_x_plain, (canvas, shifts)),
            ("shear_y", ck.shear_y, ck._shear_y_plain,
             (canvas_y, shifts_y))):
        row = {"launches": launches[name], "max_abs_err": errs[name],
               "bound_ms": bms, "bound_by": by}
        row.update(kernel_times(lambda k=kern, a=cv, s=sh: k(a, s),
                                lambda p=plain, a=cv, s=sh: p(a, s),
                                lib(name, cv)))
        rows[name] = row
        log(f"K9 {name} ({b} x {c} x {c} f32 canvas, "
            f"{'row' if name == 'shear_x' else 'column'} mode): launches "
            f"{launches[name]} per warp, all bit-equal; one pass: "
            f"{fmt_times(row, 'grid_sample')}, bound {bms:.5f} ms ({by}, "
            f"{nbytes} B) [{card_line}]")
    col = rows["shear_y"]
    col["before_device_ms"] = device_ms(chain())
    col["before_call_ms"] = cuda_ms(chain())
    log(f"K9 column pass before (transpose copy + row pass + transpose "
        f"copy): device {col['before_device_ms']:.4f} ms / call "
        f"{col['before_call_ms']:.4f} ms; column mode / row mode device "
        f"{col['device_ms'] / rows['shear_x']['device_ms']:.3f} "
        f"[{card_line}]")
    if parent is not None:
        if not torch.equal(parent.shear_x(canvas, shifts), rec_x.outs[0]):
            raise AssertionError("parent shear_x differs")
        new, old = in_turns(lambda: ck.shear_x(canvas, shifts),
                            lambda: parent.shear_x(canvas, shifts))
        cnew, cold = in_turns(chain(), chain(parent.shear_x))
        rows["shear_x"]["parent_device_ms"] = old["device"]
        rows["shear_x"]["parent_call_ms"] = old["call"]
        col["parent_chain_device_ms"] = cold["device"]
        col["parent_chain_call_ms"] = cold["call"]
        log(f"K9 in turns (parent, new, new, parent), one row pass: device "
            f"new {new['device']} parent {old['device']} ms, call new "
            f"{new['call']} parent {old['call']} ms; the column pass before "
            f"with the parent's kernel: device {cold['device']} ms, call "
            f"{cold['call']} ms (with this tree's: {cnew['device']}, "
            f"{cnew['call']}) [{card_line}]")
    exact = warp.warp_affine(x, m, HW_1080P, device=DEV)
    inner = (slice(hh // 5, hh - hh // 5), slice(ww // 6, ww - ww // 6))
    dev = (out[inner].float() - exact[inner].float()).abs()
    log(f"shear route vs exact K7 warp at 25 deg (inner region): mean |diff| "
        f"{float(dev.mean()):.3f}, max {float(dev.max()):.0f} of 255; whole "
        f"shear warp device {device_ms(fn):.3f} ms, call {cuda_ms(fn):.3f} "
        f"ms [{card_line}]")
    return rows["shear_x"], col


# --------------------------------------------------------------------------
# the third slice: ORB variants, Lucas-Kanade, fused preprocess
# --------------------------------------------------------------------------


def windows_case(args, kwargs, card_line, label):
    """K4 on one recorded call: kernel vs plain (bit-equal), times, the
    library call (one advanced-indexing gather with prebuilt indices) and
    the byte bound. Returns a dict for the kernels line."""
    b = inspect.signature(ck._windows_plain).bind(*args, **kwargs)
    b.apply_defaults()
    src, xy, win_h = b.arguments["src"], b.arguments["xy"], \
        b.arguments["win_h"]
    got = ck.windows(*args, **kwargs)
    want = ck._windows_plain(*args, **kwargs)
    torch.cuda.synchronize()
    err = max_err(got, want)
    if err != 0.0:
        raise AssertionError(f"windows ({label}) differs from its plain "
                             f"version: {err}")
    oy, ox, xmax, ymax = ck._window_frame(
        src, win_h, b.arguments["cy_off"], b.arguments["cx_off"],
        b.arguments["prepared"])
    hs, ws = src.shape
    xyl = xy.long()
    cx, cy = xyl[:, 0].clamp(0, xmax), xyl[:, 1].clamp(0, ymax)
    ri = (cy[:, None] + torch.arange(win_h, device=DEV) - oy).clamp(
        0, hs - 1)[:, :, None]
    ci = (cx[:, None] + torch.arange(128, device=DEV) - ox).clamp(
        0, ws - 1)[:, None, :]
    if not torch.equal(src[ri, ci], got):
        raise AssertionError("K4 library gather disagrees")
    touched = torch.zeros_like(src, dtype=torch.bool)
    touched[ri, ci] = True
    nbytes = int(touched.sum()) * 4 + xy.numel() * 4 + got.numel() * 4
    bms, by = bound(nbytes)
    row = {"case": label, "max_abs_err": err, "bound_ms": bms,
           "bound_by": by}
    row.update(kernel_times(lambda: ck.windows(*args, **kwargs),
                            lambda: ck._windows_plain(*args, **kwargs),
                            lambda: src[ri, ci]))
    log(f"K4 windows {label} ({tuple(src.shape)} f32 -> {tuple(got.shape)}):"
        f" bit-equal; {fmt_times(row, 'advanced indexing')}, bound "
        f"{bms:.5f} ms ({by}, {nbytes} B) [{card_line}]")
    return row


class ExpandedLaneGather:
    """While the block runs, ``ck.lane_gather`` expands a broadcast index
    to one row per source row and calls ``mod.lane_gather`` (this tree's
    or the parent's) on it: the describe route before the broadcast
    mode."""

    def __init__(self, mod):
        self.mod = mod

    def __enter__(self):
        self.saved = ck.lane_gather
        # taken before the patch: with this tree's ck, the original wrapper
        general = self.mod.lane_gather

        def expanded(src, idx):
            g = src.shape[0] // max(idx.shape[0], 1)
            full = idx[:, None, :].expand(idx.shape[0], g, 128).reshape(
                -1, 128)
            return general(src, full.contiguous())

        ck.lane_gather = expanded

    def __exit__(self, *exc):
        ck.lane_gather = self.saved


def lane_gather_cases(calls, launches, card_line, parent=None):
    """K5 on the describe's recorded calls, (K * 48, 128) windows with a
    (K, 128) index: both modes bit-equal to the plain version on the
    expanded index, then each timed beside its bound and torch.gather,
    and the parent's kernel in turns. Returns the kernels-line row: the
    general mode's numbers (the TPU kernel's contract) under ``"mode":
    "general"``, with the path's launches of the entry point (all in the
    broadcast mode) and both modes under ``cases``."""
    err = 0.0
    for src, idx in (c[0] for c in calls):
        full = idx.repeat_interleave(src.shape[0] // idx.shape[0], 0)
        want = ck._lane_gather_plain(src, full)
        for got in (ck.lane_gather(src, idx), ck.lane_gather(src, full),
                    ck._lane_gather_plain(src, idx)):
            e = max_err(got, want)
            if e != 0.0:
                raise AssertionError(f"lane_gather differs from its plain "
                                     f"version: {e}")
            err = max(err, e)
    src, idx = calls[0][0]
    g = src.shape[0] // idx.shape[0]
    full = idx.repeat_interleave(g, 0).contiguous()
    full64 = full.long().clamp(0, 127)
    # the broadcast index as a stride-0 view: torch.gather without a copy
    view64 = idx.long().clamp(0, 127)[:, None, :].expand(
        idx.shape[0], g, 128)
    src3 = src.view(idx.shape[0], g, 128)
    want = ck._lane_gather_plain(src, idx)
    if not (torch.equal(torch.gather(src, 1, full64), want)
            and torch.equal(torch.gather(src3, 2, view64).reshape(-1, 128),
                            want)):
        raise AssertionError("K5 library gathers disagree")
    cases = []
    for mode, index, lib, lib_name in (
            ("broadcast", idx, lambda: torch.gather(src3, 2, view64),
             "torch.gather, the index a stride-0 view"),
            ("general", full, lambda: torch.gather(src, 1, full64),
             "torch.gather (int64 indices ready)")):
        nbytes = src.numel() * 4 * 2 + index.numel() * 4
        bms, by = bound(nbytes)
        row = {"case": f"{mode}, {tuple(src.shape)} src, "
                       f"{tuple(index.shape)} idx", "mode": mode,
               "max_abs_err": err, "bound_ms": bms, "bound_by": by,
               "launches": launches if mode == "broadcast" else 0}
        row.update(kernel_times(
            lambda i=index: ck.lane_gather(src, i),
            lambda i=index: ck._lane_gather_plain(src, i), lib))
        extra = ""
        if mode == "broadcast":
            row["library2_device_ms"] = device_ms(
                lambda: torch.gather(src, 1, full64))
            row["library2_call_ms"] = cuda_ms(
                lambda: torch.gather(src, 1, full64))
            extra = (f"; torch.gather on the expanded int64 index device "
                     f"{row['library2_device_ms']:.4f} / call "
                     f"{row['library2_call_ms']:.4f} ms")
        log(f"K5 lane_gather {mode} ({tuple(src.shape)} f32 + "
            f"{tuple(index.shape)} i32 idx): "
            + ("launches 4 per describe, " if mode == "broadcast" else "")
            + f"all 4 describe calls bit-equal in both modes; "
            f"{fmt_times(row, lib_name)}{extra}, bound {bms:.5f} ms ({by}, "
            f"{nbytes} B) [{card_line}]")
        cases.append(row)
    bc, gen = cases
    if parent is not None:
        if not torch.equal(parent.lane_gather(src, full), want):
            raise AssertionError("parent lane_gather differs")
        new, old = in_turns(lambda: ck.lane_gather(src, full),
                            lambda: parent.lane_gather(src, full))
        gen["parent_device_ms"], gen["parent_call_ms"] = (old["device"],
                                                         old["call"])

        def before():
            """The describe's route before: the expanded copy, then the
            parent's kernel."""
            f = idx[:, None, :].expand(idx.shape[0], g, 128).reshape(-1, 128)
            return parent.lane_gather(src, f.contiguous())

        bnew, bold = in_turns(lambda: ck.lane_gather(src, idx), before)
        bc["parent_chain_device_ms"], bc["parent_chain_call_ms"] = (
            bold["device"], bold["call"])
        log(f"K5 in turns (parent, new, new, parent): general mode device "
            f"new {new['device']} parent {old['device']} ms, call new "
            f"{new['call']} parent {old['call']} ms; the describe's call, "
            f"broadcast mode against the expanded copy + the parent's "
            f"kernel: device {bnew['device']} / {bold['device']} ms, call "
            f"{bnew['call']} / {bold['call']} ms [{card_line}]")
    HOST_CASES["lane_gather"] = lambda mod: mod.lane_gather(src, full)
    HOST_CASES["lane_gather broadcast"] = lambda mod: mod.lane_gather(src,
                                                                     idx)
    row = dict(gen)
    row["launches"] = launches
    row["cases"] = cases
    return row


def phase_orb_variants(card_line, img1, parent=None):
    """The unpaired, lane-gather, odd-budget, gather and quadtree forms of
    ORB and harris_at_windows. Returns (K4 row, K5 row)."""
    cfg = orb.OrbConfig()
    frame = torch.as_tensor(img1, device=DEV)

    def run(cfg=cfg, **kw):
        return orb.orb_detect_and_describe(frame, cfg, device=DEV, **kw)

    paired = run()
    with Record("brief_from_windows", orb) as rec_desc:
        unp, n_unp = counted(lambda: run(describe="unpaired"))
    log(f"orb unpaired launches: {n_unp}")
    only(n_unp, {"fast_harris": 1, "windows": 2, "brief_rotated": 1})
    for name in ("xy", "mask", "angle", "descriptors"):
        if not torch.equal(getattr(unp, name), getattr(paired, name)):
            raise AssertionError(f"unpaired ORB {name} differs from paired")
    lg, n_lg = counted(lambda: run(brief="lane_gather"))
    log(f"orb lane_gather launches: {n_lg}")
    only(n_lg, {"fast_harris": 1, "windows": 2, "lane_gather": 4})
    if not torch.equal(lg.descriptors, paired.descriptors):
        raise AssertionError("lane_gather BRIEF differs from paired")
    log("orb variants: unpaired xy/mask/angle/descriptors and lane_gather "
        "descriptors bit-equal to the paired run "
        f"({int(paired.mask.sum())} keypoints)")
    odd, n_odd = counted(lambda: run(orb.OrbConfig(n_features=2001)))
    only(n_odd, {"fast_harris": 1, "windows": 2, "brief_rotated": 1})
    if tuple(odd.descriptors.shape) != (2001, 256):
        raise AssertionError("odd budget sum: descriptor shape")
    gat, n_gat = counted(lambda: run(describe="gather"))
    only(n_gat, {"fast_harris": 1})
    flips = int((gat.descriptors != paired.descriptors)[paired.mask].sum())
    log(f"orb n_features=2001: {int(odd.mask.sum())} keypoints, launches "
        f"{n_odd}; describe=gather: {flips} of "
        f"{int(paired.mask.sum()) * 256} bits differ from the window forms "
        "(angles from gathered patches, another summation order)")

    with rec_desc:
        quad, n_quad = counted(lambda: orb.orb_detect_and_describe_quadtree(
            frame, cfg, device=DEV))
    log(f"orb quadtree launches: {n_quad}")
    # per level: K1's score-only form (the detection), 2 window calls and
    # one describe
    only(n_quad, {"fast_score": 8, "windows": 16, "brief_rotated": 8})
    n_bits = check_brief_calls(rec_desc.calls, "unpaired and quadtree")
    if len(rec_desc.calls) != 9 or n_bits != 2 * cfg.n_features * 256:
        raise AssertionError("recorded describe calls of the unpaired and "
                             "quadtree forms")
    log(f"unpaired and quadtree descriptors: {n_bits} bits over 9 "
        f"brief_rotated calls (level budgets "
        f"{sorted({int(a[1].shape[0]) for a, _ in rec_desc.calls})}) equal "
        f"the index form's on the same windows and angles")
    kept = [int(quad.mask[quad.octave == i].sum())
            for i in range(cfg.n_levels)]
    log(f"orb quadtree: keypoints kept per level {kept} of budgets "
        f"{orb._level_budgets(cfg)}")
    if tuple(quad.descriptors.shape) != (cfg.n_features, 256) or \
            sum(kept) < cfg.n_features // 2:
        raise AssertionError("quadtree ORB output")

    gray_f = frame.to(torch.float32)
    lvl0 = paired.mask & (paired.octave == 0)
    xy0 = torch.round(paired.xy[lvl0]).to(torch.int32).contiguous()
    hw, n_hw = counted(lambda: responses.harris_at_windows(gray_f, xy0))
    only(n_hw, {"windows": 1})
    dense = responses.harris_response(gray_f, grad="central", block_size=5)
    inner = ((xy0[:, 0] >= 4) & (xy0[:, 0] < W - 4)
             & (xy0[:, 1] >= 4) & (xy0[:, 1] < H - 4))
    at = dense[xy0[inner, 1].long(), xy0[inner, 0].long()]
    rel = float((hw[inner] - at).abs().max() / at.abs().max())
    log(f"harris_at_windows at {int(inner.sum())} interior level-0 "
        f"keypoints vs the dense map: max |diff| / max |response| "
        f"{rel:.3e}")
    if not rel < 1e-4:
        raise AssertionError("harris_at_windows disagrees with the dense "
                             "map")

    # the kernels on the very inputs of the unpaired path
    with Record("windows") as rec_w, Record("brief_rotated") as rec_b, \
            Record("lane_gather") as rec_l, \
            Record("brief_from_windows", orb) as rec_bw:
        run(describe="unpaired")
        run(brief="lane_gather")
    if len(rec_w.calls) != 4 or len(rec_b.calls) != 1 or \
            len(rec_l.calls) != 4:
        raise AssertionError("recorded calls of the unpaired path")
    cases = [windows_case(a, kw, card_line, f"orb {what} canvas")
             for (a, kw), what in zip(rec_w.calls[:2], ("gray", "blurred"))]
    a4, kw4 = rec_w.calls[0]
    HOST_CASES["windows"] = lambda mod: mod.windows(*a4, **kw4)
    a, kw = rec_b.calls[0]
    if not torch.equal(ck.brief_rotated(*a, **kw),
                       ck._brief_rotated_plain(*a, **kw)):
        raise AssertionError("brief_rotated on (K, 48, 128) windows differs "
                             "from its plain version")
    ang_u = unp.angle
    _, s_u = brief_index_form(a[0], ang_u)
    flat_u = a[0].reshape(a[0].shape[0], -1)
    rows_u, cols_u = orb._brief_tap_coords(ang_u, cfg.pattern_seed,
                                           cfg.pattern)
    idx_u = rows_u.long() * 128 + cols_u.long()
    if not torch.equal(torch.gather(flat_u, 1, idx_u), s_u):
        raise AssertionError("K3 library gather disagrees (unpaired)")
    k3u = kernel_times(lambda: ck.brief_rotated(*a, **kw),
                       lambda: ck._brief_rotated_plain(*a, **kw),
                       lambda: torch.gather(flat_u, 1, idx_u))
    # the window values the taps touch, each once; cos, sin, pattern, bits
    uniq_u = torch.unique(idx_u + torch.arange(
        idx_u.shape[0], device=DEV)[:, None] * (48 * 128)).numel()
    rest = ang_u.numel() * 8 + 256 * 16 + ang_u.numel() * 256
    bms, by = bound(uniq_u * 4 + rest)
    staged_ms = bound(a[0].numel() * 4 + rest)[0]
    k3u.update({"case": "brief_rotated, unpaired, 2000 x (48, 128) windows",
                "max_abs_err": 0.0, "bound_ms": bms, "bound_by": by,
                "staged_ms": staged_ms})
    chain_dev = device_ms(lambda: brief_index_form(a[0], ang_u))
    chain_call = cuda_ms(lambda: brief_index_form(a[0], ang_u))
    log(f"K3 brief_rotated on {tuple(a[0].shape)} windows (unpaired): "
        f"bit-equal; "
        f"{fmt_times(k3u, 'torch.gather (int64 indices ready)')}, bound "
        f"{bms:.5f} ms ({by}, the {uniq_u} window values the taps touch; "
        f"every window staged whole: {staged_ms:.5f} ms); the index-form "
        f"chain (_brief_tap_coords + "
        f"brief_sample + compare) device {chain_dev:.4f} ms / call "
        f"{chain_call:.4f} ms [{card_line}]")
    k4 = dict(cases[0])
    k4["cases"] = cases
    k4["paths"] = {"orb unpaired": n_unp["windows"],
                   "orb lane_gather": n_lg["windows"],
                   "orb n_features=2001": n_odd["windows"],
                   "orb quadtree": n_quad["windows"],
                   "harris_at_windows": n_hw["windows"]}

    k5 = lane_gather_cases(rec_l.calls, n_lg["lane_gather"], card_line,
                           parent)
    def stage(name, fn):
        log(f"stage {name}: {cuda_ms(fn):.3f} ms [{card_line}]")

    stage("orb paired (1 frame)", run)
    stage("orb unpaired (1 frame)", lambda: run(describe="unpaired"))
    # the lane-gather describe before (each index row expanded over its
    # 48 window rows, the general mode; the parent's kernel with --parent)
    # and after (the broadcast mode), in turns: the frame, and the BRIEF
    # step alone on the frame's recorded windows and angles
    a_bw, kw_bw = rec_bw.calls[-1]
    before_name = ", index expanded" + (" (parent's kernel)" if parent
                                       else "")
    for before in (True, False, False, True) * 2:
        with (ExpandedLaneGather(parent or ck) if before
              else contextlib.nullcontext()):
            stage("orb unpaired, lane_gather BRIEF (1 frame)"
                  + (before_name if before else ""),
                  lambda: run(brief="lane_gather"))
    for before in (True, False, False, True) * 2:
        with (ExpandedLaneGather(parent or ck) if before
              else contextlib.nullcontext()):
            log(f"stage lane_gather BRIEF alone (brief_from_windows, "
                f"{tuple(a_bw[0].shape)} windows)"
                + (before_name if before else "") + ": "
                f"{cuda_ms(lambda: orb.brief_from_windows(*a_bw, **kw_bw), 100):.3f}"
                f" ms [{card_line}]")
    stage("orb gather form (1 frame)", lambda: run(describe="gather"))
    stage("orb quadtree (1 frame)",
          lambda: orb.orb_detect_and_describe_quadtree(frame, cfg,
                                                       device=DEV))
    stage("harris_at_windows (level-0 keypoints)",
          lambda: responses.harris_at_windows(gray_f, xy0))
    return k4, k5, k3u, paired


def phase_lk(card_line, img1, feats):
    """Track frame 1's ORB keypoints into an affine warp of it. Returns
    (K4 cases, K4 launches by path, K7 launches by path)."""
    params = optical_flow.PyrLKParams()
    frame1 = torch.as_tensor(img1, device=DEV)
    m = warp.get_rotation_matrix2d((W / 2, H / 2), 2.0, 1.0,
                                   device="cpu").double().numpy()
    m[:, 2] += (6.0, -4.0)
    pts = feats.xy[feats.mask].contiguous()
    true = pts.double().cpu().numpy() @ m[:, :2].T + m[:, 2]
    p0 = pts.cpu().numpy()
    margin = 24.0
    interior = ((np.minimum(p0, true) >= margin).all(1)
                & (np.maximum(p0[:, 0], true[:, 0]) <= W - 1 - margin)
                & (np.maximum(p0[:, 1], true[:, 1]) <= H - 1 - margin))

    def path(method, stats=None):
        frame2 = warp.warp_affine(frame1, m, (H, W), device=DEV)
        return optical_flow.calc_optical_flow_pyr_lk(
            frame1, frame2, pts, params, method=method, device=DEV,
            stats=stats)

    results, paths, remaps, cases = {}, {}, {}, []
    for method in ("taps", "windows", "gather"):
        path(method)                                # warm-up
        stats = {}
        with Record("windows") as rec:
            res, launches = counted(lambda: path(method, stats))
        iters = stats["iterations"]
        want = {"taps": sum(4 + it for it in iters),
                "windows": 4 * len(iters), "gather": 0}[method]
        only(launches, {"remap": 1, "windows": want} if want
             else {"remap": 1})
        per_level = {}
        for a, _ in rec.calls:
            per_level[tuple(a[0].shape)] = per_level.get(
                tuple(a[0].shape), 0) + 1
        st = res.status.cpu().numpy()
        epe = np.linalg.norm(res.points.double().cpu().numpy() - true,
                             axis=1)
        tracked = float(st[interior].mean())
        med = float(np.median(epe[interior & st]))
        if not (torch.isfinite(res.points).all()
                and torch.isfinite(res.errors).all()):
            raise AssertionError(f"lk {method}: result not finite")
        ms = cuda_ms(lambda: path(method), reps=5, warmup=1)
        log(f"lk {method}: {len(p0)} points ({int(interior.sum())} "
            f"interior), tracked {int(st.sum())} ({tracked:.4f} of "
            f"interior), end-point error median {med:.4f} px, p95 "
            f"{float(np.percentile(epe[interior & st], 95)):.4f} px; Newton "
            f"iterations per level (finest first) {iters}; K4 launches "
            f"{launches['windows']} = per level "
            f"{[per_level[k] for k in sorted(per_level, reverse=True)]}; "
            f"warp + track {ms:.3f} ms [{card_line}]")
        results[method] = res
        paths[f"lk {method}"] = launches["windows"]
        remaps[f"lk {method}"] = launches["remap"]
        if method == "taps":
            if not (tracked >= 0.9 and med < 0.1):
                raise AssertionError("lk taps outside the bounds (>= 90% "
                                     "of interior points, median < 0.1 px)")
            for a, kw in rec.calls:           # every call of the path
                if not torch.equal(ck.windows(*a, **kw),
                                   ck._windows_plain(*a, **kw)):
                    raise AssertionError("windows (lk taps) differs from "
                                         "its plain version")
            cases.append(windows_case(*rec.calls[-1], card_line,
                                      "lk taps, level 0"))
        if method == "windows":
            cases.append(windows_case(*rec.calls[-1], card_line,
                                      "lk windows, level 0"))
        device_share(f"lk {method} (warp + track)", lambda: path(method),
                     card_line)
    for method in ("windows", "gather"):
        both = (results[method].status & results["taps"].status).cpu().numpy()
        d = (results[method].points - results["taps"].points).norm(
            dim=1).cpu().numpy()
        log(f"lk {method} vs taps: {int(both.sum())} tracked by both, "
            f"|difference| median {float(np.median(d[both])):.5f} px, median "
            f"over interior {float(np.median(d[both & interior])):.5f} px, "
            f"max over interior {float(d[both & interior].max()):.4f} px")
    pre = optical_flow.build_lk_precomputed(
        frame1, warp.warp_affine(frame1, m, (H, W), device=DEV), params,
        device=DEV)
    log(f"stage build_lk_precomputed: "
        f"{cuda_ms(lambda: optical_flow.build_lk_precomputed(frame1, pre.next_levels[0], params, device=DEV)):.3f}"
        f" ms [{card_line}]")
    return cases, paths, remaps


def phase_orb_levels17(card_line, img1):
    """ORB with 17 pyramid levels on view 1: K1 launches twice (16 levels,
    then 1) and the features equal the route with one K1 launch per level
    (``_select_level(..., maps=None)``)."""
    cfg = orb.OrbConfig(n_levels=17, scale_factor=1.1)
    frame = torch.as_tensor(img1, device=DEV)

    def run():
        return orb.orb_detect_and_describe(frame, cfg, device=DEV)

    run()                                           # warm-up
    with Record("_fast_harris_chunk") as rec:
        feats, launches = counted(run)
    log(f"orb 17 levels launches: {launches}")
    only(launches, {"fast_harris": 2, "windows_paired": 2,
                    "brief_rotated": 1})
    chunks = [len(a[0]) for a, _ in rec.calls]
    if chunks != [16, 1]:
        raise AssertionError(f"17 levels went to K1 in chunks {chunks}")
    levels = orb._pyramid(frame, cfg)
    budgets = orb._level_budgets(cfg)
    sels = [orb._select_level(lv, b, cfg) for lv, b in zip(levels, budgets)]
    want = {"xy": torch.cat([sl[0] * cfg.scale_factor ** i
                             for i, sl in enumerate(sels)]),
            "score": torch.cat([sl[1] for sl in sels]),
            "mask": torch.cat([sl[2] for sl in sels])}
    with PerLevelK1():
        per_level = run()
    for name in feats._fields:
        if name in want and not torch.equal(getattr(feats, name),
                                            want[name]):
            raise AssertionError(f"17-level ORB {name} differs from "
                                 "_select_level(..., maps=None)")
        if not torch.equal(getattr(feats, name), getattr(per_level, name)):
            raise AssertionError(f"17-level ORB {name} differs from the "
                                 "route with one K1 launch per level")
    kept = [int(feats.mask[feats.octave == i].sum())
            for i in range(cfg.n_levels)]
    log(f"orb 17 levels (scale 1.1, levels {tuple(levels[0].shape)} .. "
        f"{tuple(levels[-1].shape)}): K1 chunks {chunks}, launches 2; "
        f"keypoints kept per level {kept} of budgets {budgets}; xy, score, "
        f"mask equal _select_level(..., maps=None), every field equal the "
        f"route with one K1 launch per level; one frame "
        f"{cuda_ms(run):.3f} ms [{card_line}]")


def check_track_kernels(k1, k2, k3, label="track"):
    """The tracked frame's K1, K2 and K3 calls, recorded on the main path
    (``Record`` of ``fast_harris_levels``, ``windows_paired`` and
    ``brief_rotated``), held to their plain versions on the same inputs:
    every output must be bit-equal. Returns each kernel's max |error|."""
    errs = {"fast_harris": 0.0, "windows_paired": 0.0, "brief_rotated": 0.0}
    pairs = {"fast_harris": [], "windows_paired": [], "brief_rotated": []}
    for (args, kwargs), maps in zip(k1.calls, k1.outs):
        levels, thr = args
        for lv, got in zip(levels, maps):
            pairs["fast_harris"] += list(zip(
                got, ck._fast_harris_plain(lv, thr)))
    for (args, kwargs), got in zip(k2.calls, k2.outs):
        pairs["windows_paired"].append(
            (got, ck._windows_paired_plain(*args, **kwargs)))
    for (args, kwargs), got in zip(k3.calls, k3.outs):
        pairs["brief_rotated"].append(
            (got, ck._brief_rotated_plain(*args, **kwargs)))
    shapes = {}
    for name, found in pairs.items():
        if not found:
            raise AssertionError(f"{label}: no {name} call was recorded")
        for got, want in found:
            errs[name] = max(errs[name], max_err(got, want))
            if not torch.equal(got, want):
                raise AssertionError(f"{label}: {name} at {tuple(got.shape)} "
                                     "differs from its plain version")
        shapes[name] = [tuple(got.shape) for got, _ in found]
    log(f"{label}: the frame's K1/K2/K3 outputs at the path's own shapes "
        f"bit-equal to their plain versions on the same inputs: {shapes}")
    return errs


def phase_track(card_line):
    """The per-frame tracking step at the SLAM loop's width: a map of
    views 1 and 2 (ORB at SlamConfig()'s OrbConfig(n_features=1000,
    n_levels=4), each valid keypoint lifted to its exact 3-D point, packed
    descriptors, a bucket of 2048 rows), the third view at a known pose
    (ORB, 1000 rows padded to 1024), then ``track_step`` with
    SlamConfig(). Returns the frame's K1–K3 launches."""
    t_phase = time.perf_counter()
    scfg = slam.SlamConfig()
    ocfg = orb.OrbConfig(n_features=scfg.n_features, n_levels=scfg.n_levels)
    texs = scene_textures()
    xyz, desc = [], []
    for rot, origin in ((np.eye(3), np.zeros(3)), VIEW2):
        f = orb.orb_detect_and_describe(render_view(rot, origin, texs), ocfg,
                                        device="cuda")
        xyz.append(_hit(f.xy[f.mask].double().cpu().numpy(), rot, origin))
        desc.append(slam._pack(f.descriptors[f.mask]))
    n_map = sum(len(p) for p in xyz)
    nm = slam._bucket(n_map, 256)
    maps = {"map_desc": slam._pad_rows(torch.cat(desc), nm),
            "map_mask": torch.arange(nm, device=DEV) < n_map,
            "map_xyz": slam._pad_rows(torch.as_tensor(
                np.concatenate(xyz), dtype=torch.float32, device=DEV), nm)}
    k = torch.as_tensor(K_EUROC, dtype=torch.float32, device=DEV)
    rot3, origin3 = VIEW3
    img3 = torch.as_tensor(render_view(rot3, origin3, texs), device=DEV)
    nf = slam._bucket(ocfg.n_features, 256)

    def frame_inputs():
        f = orb.orb_detect_and_describe(img3, ocfg, device="cuda")
        return {"frame_desc": slam._pad_rows(slam._pack(f.descriptors), nf),
                "frame_mask": slam._pad_rows(f.mask, nf, False),
                "frame_xy": slam._pad_rows(f.xy, nf)}

    def step(fin, gen=None, draw=None, device="cuda"):
        ins = {**fin, **maps, "k": k}
        if device == "cpu":
            ins = {name: v.cpu() for name, v in ins.items()}
            draw = None if draw is None else draw.cpu()
        return slam.track_step(
            **ins, max_distance=scfg.match_max_distance,
            ratio=scfg.match_ratio, threshold_px=scfg.pnp_threshold_px,
            generator=gen, sample_idx=draw, device=device)

    fin = frame_inputs()                        # warm-up (cuBLAS, caches)
    step(fin, torch.Generator(device=DEV).manual_seed(SEED))
    torch.cuda.synchronize()
    # the main path, counted: the frame's ORB, then the step, which must
    # not wait for the device anywhere
    gen = torch.Generator(device=DEV).manual_seed(SEED)

    recs = [Record(name) for name in ("fast_harris_levels", "windows_paired",
                                      "brief_rotated")]

    def path():
        with recs[0], recs[1], recs[2]:
            fin = frame_inputs()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fin, step(fin, gen)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    (fin, res), launches = counted(path)
    log(f"track: launches for the frame's ORB and the step {launches}; "
        f"the step ran under torch.cuda.set_sync_debug_mode('error')")
    only(launches, {"fast_harris": 1, "windows_paired": 2,
                    "brief_rotated": 1})
    errs = check_track_kernels(*recs)
    r = res.pose.rotation.double().cpu().numpy()
    t = res.pose.translation.double().cpu().numpy()
    if not (np.isfinite(r).all() and np.isfinite(t).all()):
        raise AssertionError("track: pose not finite")
    n_match = int(res.match_mask.sum())
    n_inl = int(res.n_inliers)
    rerr = rot_err_deg(r, rot3)
    cerr = float(np.linalg.norm(-r.T @ t - origin3))
    log(f"track: map {n_map} points (bucket {nm}), frame "
        f"{int(fin['frame_mask'].sum())} keypoints (bucket {nf}), matches "
        f"{n_match}, inliers {n_inl}, rotation error {rerr:.5f} deg, centre "
        f"error {cerr:.5f} (planes at depth ~5)")
    if not (rerr <= 0.1 and cerr <= 0.02 and n_inl >= 0.5 * n_match):
        raise AssertionError("track: pose outside the bounds (0.1 deg, 0.02 "
                             "units, inliers >= half the matches)")

    # the CPU route on the same inputs and the same draw
    draw = sample_minimal_sets(torch.Generator(device=DEV).manual_seed(SEED),
                               nf, res.match_mask, 256, 6)
    card_res = step(fin, draw=draw)
    cpu_res = step(fin, draw=draw, device="cpu")
    d_rot = chord_rad(card_res.pose.rotation.cpu().numpy(),
                      cpu_res.pose.rotation.numpy())
    d_t = float((card_res.pose.translation.cpu()
                 - cpu_res.pose.translation).abs().max())
    d_n = int(card_res.n_inliers) - int(cpu_res.n_inliers)
    log(f"track card vs cpu, same draw: match idx and mask equal "
        f"{torch.equal(card_res.match_idx.cpu(), cpu_res.match_idx)} / "
        f"{torch.equal(card_res.match_mask.cpu(), cpu_res.match_mask)}, "
        f"R {d_rot:.3e} rad apart, t {d_t:.3e}, n_inliers {d_n:+d}; bound: "
        f"equal matches (integer distances from an exact float32 product), "
        f"R <= 1e-4 rad, t <= 1e-3, n_inliers +-2 (reductions and cuBLAS "
        f"products round differently; the LM takes both routes to the "
        f"minimum of the same inlier set)")
    if not (torch.equal(card_res.match_idx.cpu(), cpu_res.match_idx)
            and torch.equal(card_res.match_mask.cpu(), cpu_res.match_mask)
            and d_rot <= 1e-4 and d_t <= 1e-3 and abs(d_n) <= 2):
        raise AssertionError("track: the card and the CPU route differ")

    # times
    world = maps["map_xyz"][res.match_idx.clamp(min=0).long()]
    cases = {
        "step": lambda: step(fin, gen),
        "match_descriptors_packed": lambda: matching.match_descriptors_packed(
            fin["frame_desc"], maps["map_desc"], fin["frame_mask"],
            maps["map_mask"], max_distance=scfg.match_max_distance,
            ratio=scfg.match_ratio, device="cuda"),
        "solve_pnp_ransac": lambda: pnp.solve_pnp_ransac(
            world, fin["frame_xy"], k, threshold_px=scfg.pnp_threshold_px,
            mask=res.match_mask, generator=gen, device="cuda"),
        "orb (frame)": lambda: orb.orb_detect_and_describe(img3, ocfg,
                                                            device="cuda"),
    }
    out = {"map_points": n_map, "matches": n_match, "inliers": n_inl,
           "rot_err_deg": rerr, "centre_err": cerr,
           "cpu_route": {"rot_rad": d_rot, "t": d_t, "n_inliers": d_n},
           "orb_launches": {name: launches[name] for name in (
               "fast_harris", "windows_paired", "brief_rotated")},
           "kernel_errs": errs,
           "checks_s": time.perf_counter() - t_phase}
    # a profiler trace of the step holds ~35,000 records a call (reading
    # one takes seconds), so the device time of the step and of its parts
    # is the device busy time of one profiled call (device_share), which
    # also counts the launches
    for name, fn in cases.items():
        reps = REPS if name == "step" else 10
        out[name] = {"call_ms": cuda_ms(fn, reps=reps)}
        if name == "orb (frame)":
            out[name]["device_ms"] = device_ms(fn)
        else:
            out[name].update(device_share(f"track {name}", fn, card_line)
                             or {})
            out[name]["device_ms"] = out[name].get("busy_ms")
        log(f"track {name}: call {out[name]['call_ms']:.3f} ms (median of "
            f"{reps}), device {out[name]['device_ms']} ms [{card_line}]")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"track: {json.dumps(out)}")
    log(f"track phase: {out['phase_s']:.1f} s (setup and checks "
        f"{out['checks_s']:.1f} s)")
    return out["orb_launches"], errs


# --------------------------------------------------------------------------
# the eighth slice: the SLAM back end (BA, PGO, bag of words)
# --------------------------------------------------------------------------


def _quat_np(rot) -> np.ndarray:
    """wxyz quaternion of a rotation matrix with trace > −1 (every
    rotation the back-end scenes make)."""
    w = np.sqrt(max(1.0 + np.trace(rot), 1e-12)) / 2.0
    return np.array([w, (rot[2, 1] - rot[1, 2]) / (4 * w),
                     (rot[0, 2] - rot[2, 0]) / (4 * w),
                     (rot[1, 0] - rot[0, 1]) / (4 * w)])


def _quat_rot(q) -> np.ndarray:
    """Rotation matrices of (..., 4) wxyz quaternions (float64)."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = np.moveaxis(q, -1, 0)
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(q.shape[:-1] + (3, 3))


def local_ba_problem(device, seed: int = SEED, n_kf: int = 5,
                     n_pts: int = 1500, noise_px: float = 0.5):
    """Local BA as the SLAM loop runs it (``SlamConfig().ba_window`` = 5
    keyframes): keyframes 0.15 apart along x, each turned by ~1°, viewing
    ``n_pts`` points at depth 5–9, each point seen by a run of 2–5
    consecutive keyframes, 0.5 px noise; keyframes 2–4 perturbed by ~0.6°
    and ~0.01, the points by 0.05. Bucketed as ``_bundle_adjust`` buckets
    (kornia_tpu/slam/system.py:455-476): points to _bucket(n + 1, 64)
    with fixed dummy points (the last takes the zero-weight padding
    observations), observations to _bucket(M, 256), K to _bucket(·, 4),
    keyframes 0 and 1 fixed. Returns (problem, true poses (n_kf, 7))."""
    rng = np.random.default_rng(seed)
    rots = [_rot_xyz(rng.normal(0, 1.0, 3)) for _ in range(n_kf)]
    centres = [np.array([0.15 * i, 0.02 * i, 0.0]) + rng.normal(0, 0.01, 3)
               for i in range(n_kf)]
    poses_gt = np.stack([np.concatenate([_quat_np(r), -r @ c])
                         for r, c in zip(rots, centres)])
    pts = rng.uniform([-2.5, -1.6, 5.0], [3.1, 1.6, 9.0], (n_pts, 3))
    first = rng.integers(0, n_kf - 1, n_pts)
    last = np.minimum(first + rng.integers(2, 6, n_pts), n_kf)
    cams, pids, uvs = [], [], []
    for c, (r, ctr) in enumerate(zip(rots, centres)):
        ids = np.nonzero((first <= c) & (c < last))[0]
        pc = (pts[ids] - ctr) @ r.T
        uv = pc[:, :2] / pc[:, 2:] * [K_EUROC[0, 0], K_EUROC[1, 1]] + \
            [K_EUROC[0, 2], K_EUROC[1, 2]]
        if not ((uv >= 0) & (uv < [W, H])).all():
            raise AssertionError("local BA scene: a point outside a view")
        cams.append(np.full(len(ids), c))
        pids.append(ids)
        uvs.append(uv + rng.normal(0, noise_px, uv.shape))
    cams, pids, uvs = (np.concatenate(cams), np.concatenate(pids),
                       np.concatenate(uvs))
    init = poses_gt.copy()
    for c in range(2, n_kf):
        dr = _rot_xyz(np.degrees(rng.normal(0, 0.01, 3)))
        init[c] = np.concatenate([_quat_np(dr @ rots[c]),
                                  dr @ poses_gt[c, 4:]
                                  + rng.normal(0, 0.01, 3)])
    pts_init = pts + rng.normal(0, 0.05, pts.shape)
    # the SLAM loop's buckets
    np_b = slam._bucket(n_pts + 1, 64)
    m_b = slam._bucket(len(uvs), 256)
    pad = m_b - len(uvs)
    pts_b = np.concatenate([pts_init, np.ones((np_b - n_pts, 3))])
    counts = np.bincount(pids, minlength=np_b)
    k_b = slam._bucket(max(int(counts.max()), 1), 4)
    fixed = np.arange(n_kf) < 2
    problem = ba.build_problem(
        init.astype(np.float32), pts_b.astype(np.float32),
        K_EUROC.astype(np.float32),
        np.concatenate([cams, np.zeros(pad, int)]),
        np.concatenate([pids, np.full(pad, n_pts)]),
        np.concatenate([uvs, np.zeros((pad, 2))]).astype(np.float32),
        obs_w=(np.arange(m_b) < len(uvs)).astype(np.float32),
        fixed_poses=fixed, fixed_points=np.arange(np_b) >= n_pts,
        max_obs_per_point=k_b, device=device)
    return problem, poses_gt


def synth_ba_problem(n_poses: int, n_points: int, seed: int, vis: float,
                     device):
    """bench_scaling.py:34-64's ``synth_problem`` (copied; it imports the
    JAX package): cameras on a line at identity rotation, each seeing a
    ``vis`` share of the points at random, 0.5 px noise, the points
    perturbed by 0.05, pose 0 fixed. Returns (problem, observations)."""
    rng = np.random.default_rng(seed)
    k = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    pts = rng.uniform([-4, -4, 4], [4, 4, 10], (n_points, 3)).astype(
        np.float32)
    poses = np.zeros((n_poses, 7), np.float32)
    poses[:, 0] = 1.0
    poses[:, 4] = np.linspace(-2, 2, n_poses)
    cams, ptid, uvs = [], [], []
    for c in range(n_poses):
        pc = pts + poses[c, 4:7]
        uv = pc[:, :2] / pc[:, 2:] * [k[0, 0], k[1, 1]] + [k[0, 2], k[1, 2]]
        ids = np.nonzero(rng.random(n_points) < vis)[0]
        cams.append(np.full(len(ids), c, np.int32))
        ptid.append(ids.astype(np.int32))
        uvs.append(uv[ids] + rng.normal(0, 0.5, (len(ids), 2)))
    fixed = np.zeros(n_poses, bool)
    fixed[0] = True
    cams = np.concatenate(cams)
    problem = ba.build_problem(
        poses, pts + rng.normal(0, 0.05, pts.shape).astype(np.float32), k,
        cams, np.concatenate(ptid),
        np.concatenate(uvs).astype(np.float32), fixed_poses=fixed,
        device=device)
    return problem, len(cams)


def pgo_ring(device, n: int = 256, radius: float = 10.0, drift: float = 0.01,
             n_loops: int = 8, seed: int = SEED):
    """A ring of ``n`` keyframes (yaw 2πi/n, on a circle of ``radius``),
    odometry edges i → i+1 and edges i → i+2 with ``drift`` noise on every
    tangent component, ``n_loops`` exact loop edges (n − n_loops + j) → j
    at weight 100; the initial poses integrate the odometry from pose 0.
    Bucketed as ``_run_pgo`` buckets (kornia_tpu/slam/system.py:574-610):
    poses to _bucket(P, 8) with identity padding (fixed), edges to
    _bucket(E, 32) with identity measurements at weight 0, pose 0 fixed.
    Returns the tensors on ``device`` and the true poses (n, 7)."""
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(n) / n
    gt = np.zeros((n, 7))
    gt[:, 0], gt[:, 3] = np.cos(ang / 2), np.sin(ang / 2)
    gt[:, 4], gt[:, 5] = radius * np.cos(ang), radius * np.sin(ang)
    gt_t = torch.as_tensor(gt, dtype=torch.float32)

    def rel(a, b):
        return liegroup.se3_compose(gt_t[b], liegroup.se3_inverse(gt_t[a]))

    ei, ej, meas, w = [], [], [], []
    for step in (1, 2):
        a = np.arange(n - step)
        noise = torch.as_tensor(rng.normal(0, drift, (len(a), 6)),
                                dtype=torch.float32)
        ei.append(a)
        ej.append(a + step)
        meas.append(liegroup.se3_compose(liegroup.se3_exp(noise),
                                         rel(a, a + step)))
        w.append(np.ones(len(a)))
    a = np.arange(n - n_loops, n)
    ei.append(a)
    ej.append(a - (n - n_loops))
    meas.append(rel(a, a - (n - n_loops)))
    w.append(np.full(n_loops, 100.0))
    init = [gt_t[0]]
    for i in range(n - 1):
        init.append(liegroup.se3_compose(meas[0][i], init[-1]))
    ei, ej, w = np.concatenate(ei), np.concatenate(ej), np.concatenate(w)
    meas = torch.cat(meas)
    p_b, e_b = slam._bucket(n, 8), slam._bucket(len(ei), 32)
    ident = torch.tensor([1.0, 0, 0, 0, 0, 0, 0])
    poses = ident.repeat(p_b, 1)
    poses[:n] = torch.stack(init)
    meas_b = ident.repeat(e_b, 1)
    meas_b[:len(ei)] = meas
    fixed = np.ones(p_b, bool)
    fixed[1:n] = False

    def on(x, dtype):
        return torch.as_tensor(x, dtype=dtype).to(device)

    return dict(poses=on(poses, torch.float32),
                edge_i=on(slam._pad_rows(torch.as_tensor(ei), e_b, 0),
                          torch.int64),
                edge_j=on(slam._pad_rows(torch.as_tensor(ej), e_b, 0),
                          torch.int64),
                edge_meas=on(meas_b, torch.float32),
                edge_weight=on(slam._pad_rows(torch.as_tensor(w), e_b, 0.0),
                               torch.float32),
                fixed=on(fixed, torch.bool)), gt


def _problem_to(problem, device):
    return ba.BAProblem(*(None if v is None else v.to(device)
                          for v in problem))


def _max_rot_err_deg(poses, gt) -> float:
    est = _quat_rot(poses.double().cpu().numpy()[:len(gt), :4])
    ref = _quat_rot(gt[:, :4])
    return max(np.degrees(chord_rad(a, b)) for a, b in zip(est, ref))


def _no_wait(fn):
    """``fn()`` under torch.cuda.set_sync_debug_mode("error"): it raises
    if anything in it waits for the device."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


class GemvMatvec:
    """While the block runs, BA's per-block matrix-vector products go
    through torch.einsum (cuBLAS batched gemv), the route they replaced."""

    def __enter__(self):
        self.saved = ba._mv, ba._mtv
        ba._mv = lambda a, x: torch.einsum("...ij,...j->...i", a, x)
        ba._mtv = lambda a, x: torch.einsum("...ij,...i->...j", a, x)

    def __exit__(self, *exc):
        ba._mv, ba._mtv = self.saved


def solve_times(label, fn, iters, card_line, device_reps=2, call_reps=3,
                warmup=1):
    """Call and device ms of a whole solve and per LM iteration, with the
    launches per iteration and the device busy share of one profiled
    solve. ``device_reps`` None: the device time is the busy time of the
    profiled solve (a trace of many solves takes too long to read)."""
    call = cuda_ms(fn, reps=call_reps, warmup=warmup)
    prof = device_share(label, fn, card_line, cuda_only=True) or {}
    dev = (device_ms(fn, reps=device_reps, warmup=0, cuda_only=True)
           if device_reps else prof.get("busy_ms"))
    out = {"call_ms": call, "device_ms": dev,
           "device_by": "device_ms" if device_reps else "profiled busy",
           "call_ms_per_iter": call / iters,
           "device_ms_per_iter": None if dev is None else dev / iters,
           "launches": prof.get("launches"),
           "launches_per_iter": (None if prof.get("launches") is None
                                 else prof["launches"] / iters),
           "busy_share": prof.get("busy_share"), "iterations": iters}
    log(f"backend {label}: call {call:.3f} ms ({call / iters:.3f} per LM "
        f"iteration), device {dev} ms ({out['device_ms_per_iter']} per "
        f"iteration, {out['device_by']}), {out['launches_per_iter']} "
        f"launches per iteration, device busy {out['busy_share']} "
        f"[{card_line}]")
    return out


def phase_backend(card_line):
    """The SLAM back end at the widths the loop and the reference's BA
    regimes use: (a) local BA, (b) dense global BA at 170 × 3000, (c) PCG
    global BA at 600 × 8000, (d) PGO on a 256-keyframe ring, (e) loop
    detection by bag of words. BA and PGO run once under sync debug mode
    "error"; each is held to the CPU route on the same inputs."""
    t_phase = time.perf_counter()
    out = {"numpy": np.__version__, "case_end_s": []}
    huber = dict(loss="huber", loss_scale=2.0)
    scfg = slam.SlamConfig()
    torch.cuda.synchronize()
    ck.reset_launch_counts()

    # (a) local BA
    prob_a, gt_a = local_ba_problem("cuda")
    pa = ba.BAParams(max_iterations=scfg.ba_iterations, **huber)
    ba.bundle_adjust_schur(prob_a, pa)                  # warm-up
    res_a = _no_wait(lambda: ba.bundle_adjust_schur(prob_a, pa))
    cpu_a = ba.bundle_adjust_schur(_problem_to(prob_a, "cpu"), pa)
    c0, c1 = float(res_a.initial_cost), float(res_a.final_cost)
    rot_a = _max_rot_err_deg(res_a.poses, gt_a)
    d_cost = (abs(c0 - float(cpu_a.initial_cost)) / c0,
              abs(c1 - float(cpu_a.final_cost)) / c1)
    d_pose = float((res_a.poses.cpu() - cpu_a.poses).abs().max())
    d_pts = float((res_a.points.cpu() - cpu_a.points).abs().max())
    log(f"backend local BA: {prob_a.poses.shape[0]} keyframes, "
        f"{int((prob_a.obs_w > 0).sum())} observations (bucket "
        f"{prob_a.obs_w.shape[0]}) of {prob_a.points.shape[0]} points "
        f"(bucket), K {prob_a.obs_by_point.shape[1]}; cost {c0:.4f} -> "
        f"{c1:.6f}, worst pose {rot_a:.5f} deg from the truth; under sync "
        f"debug mode 'error'; card vs CPU: cost rel {d_cost[0]:.3e} / "
        f"{d_cost[1]:.3e}, poses {d_pose:.3e}, points {d_pts:.3e} (bound: "
        f"the reference's for two summation orders, tests/test_optim.py:"
        f"364-369: 1e-4, 0.05, poses 1e-3) [{card_line}]")
    if not (c1 < c0 and rot_a < 0.5):
        raise AssertionError("backend local BA: cost not reduced or a pose "
                             "over 0.5 deg from the truth")
    if not (d_cost[0] <= 1e-4 and d_cost[1] <= 0.05 and d_pose <= 1e-3):
        raise AssertionError(
            f"backend local BA: card and CPU route differ (cost rel "
            f"{d_cost}, poses {d_pose})")
    out["local_ba"] = {"initial_cost": c0, "final_cost": c1,
                       "rot_err_deg": rot_a, "cpu_cost_rel": d_cost,
                       "cpu_pose": d_pose, "cpu_points": d_pts,
                       **solve_times(
                           "local BA",
                           lambda: ba.bundle_adjust_schur(prob_a, pa),
                           pa.max_iterations, card_line)}

    out["case_end_s"].append(time.perf_counter() - t_phase)
    # (b) dense global BA, 170 × 3000
    prob_b, m_b = synth_ba_problem(170, 3000, 1, 0.2, "cuda")
    pb = ba.BAParams(max_iterations=scfg.global_ba_iterations,
                     solver="dense", **huber)
    ba.bundle_adjust_schur(prob_b, pb)
    res_b = _no_wait(lambda: ba.bundle_adjust_schur(prob_b, pb))
    c0, c1 = float(res_b.initial_cost), float(res_b.final_cost)
    lam = torch.full((), pb.lambda_init, device=DEV)
    step_g = ba._schur_step(prob_b, prob_b.poses, prob_b.points, lam, pb)
    cpu_b = _problem_to(prob_b, "cpu")
    step_c = ba._schur_step(cpu_b, cpu_b.poses, cpu_b.points, lam.cpu(), pb)
    cost_g = float(ba.ba_cost(prob_b, *step_g, pb))
    cost_c = float(ba.ba_cost(cpu_b, *step_c, pb))
    d_step = (abs(cost_g - cost_c) / cost_c,
              float((step_g[0].cpu() - step_c[0]).abs().max()),
              float((step_g[1].cpu() - step_c[1]).abs().max()))
    log(f"backend dense BA 170 x 3000: {m_b} observations; cost {c0:.4f} "
        f"-> {c1:.4f} in {pb.max_iterations} iterations; one Schur step "
        f"card vs CPU: cost after it rel {d_step[0]:.3e}, poses "
        f"{d_step[1]:.3e}, points {d_step[2]:.3e} (bound: cost 1e-4, "
        f"poses 1e-3) [{card_line}]")
    if not c1 < 0.1 * c0:
        raise AssertionError("backend dense BA: final cost >= 0.1 x initial")
    if not (d_step[0] <= 1e-4 and d_step[1] <= 1e-3):
        raise AssertionError(
            f"backend dense BA: card and CPU step differ ({d_step})")
    out["dense_ba"] = {"observations": m_b, "initial_cost": c0,
                       "final_cost": c1, "cpu_step": d_step,
                       **solve_times("dense BA 170x3000",
                                     lambda: ba.bundle_adjust_schur(
                                         prob_b, pb),
                                     pb.max_iterations, card_line)}
    del prob_b, cpu_b, step_g, step_c

    out["case_end_s"].append(time.perf_counter() - t_phase)
    # (c) PCG global BA, 600 × 8000
    prob_c, m_c = synth_ba_problem(600, 8000, 1, 0.0375, "cuda")
    pc = ba.BAParams(max_iterations=scfg.global_ba_iterations,
                     solver="auto", cg_iters=60, **huber)
    if not ba._uses_pcg(pc, prob_c.poses.shape[0]):
        raise AssertionError("backend: solver='auto' did not pick PCG")
    ba.bundle_adjust_schur(prob_c, pc)
    res_c = _no_wait(lambda: ba.bundle_adjust_schur(prob_c, pc))
    dense_c = ba.bundle_adjust_schur(prob_c, ba.BAParams(
        max_iterations=pc.max_iterations, solver="dense", **huber))
    c0, c1 = float(res_c.initial_cost), float(res_c.final_cost)
    c_dense = float(dense_c.final_cost)
    log(f"backend PCG BA 600 x 8000: {m_c} observations, solver 'auto' -> "
        f"pcg, cg_iters {pc.cg_iters}; cost {c0:.4f} -> {c1:.4f}; dense on "
        f"the same problem -> {c_dense:.4f} (pcg / dense "
        f"{c1 / c_dense:.4f}, bound 1.2) [{card_line}]")
    if not (c1 < 0.1 * c0 and c1 <= 1.2 * c_dense):
        raise AssertionError("backend PCG BA: final cost >= 0.1 x initial "
                             "or > 1.2 x the dense solve's")
    out["pcg_ba"] = {"observations": m_c, "initial_cost": c0,
                     "final_cost": c1, "dense_final_cost": c_dense,
                     **solve_times("PCG BA 600x8000",
                                   lambda: ba.bundle_adjust_schur(prob_c, pc),
                                   pc.max_iterations, card_line,
                                   device_reps=None)}
    # the per-block products by broadcast and sum against the batched
    # gemv route they replaced: one LM iteration's PCG solve (60 CG
    # steps) at the first iterate, in turns (gemv, new, new, gemv)
    eqs = ba.schur_normal_equations(prob_c, prob_c.poses, prob_c.points, pc)
    lam = torch.full((), pc.lambda_init, device=DEV)
    turns = []
    for gemv in (True, False, False, True):
        with GemvMatvec() if gemv else contextlib.nullcontext():
            turns.append(("gemv" if gemv else "broadcast", solve_times(
                "PCG reduced solve 600x8000"
                + (", gemv products" if gemv else ""),
                lambda: ba._pcg_reduced_solve(prob_c, *eqs, lam,
                                              pc.cg_iters),
                1, card_line)))
    out["pcg_ba"]["cg_solve_turns"] = [
        {"route": r, **{k: t[k] for k in (
            "call_ms", "device_ms", "launches", "busy_share")}}
        for r, t in turns]
    del prob_c, dense_c, eqs

    out["case_end_s"].append(time.perf_counter() - t_phase)
    # (d) PGO on the ring
    ring, gt_d = pgo_ring("cuda")
    pd = pgo.PGOParams(max_iterations=15)
    pgo.pose_graph_optimize(**ring, params=pd)
    res_d = _no_wait(lambda: pgo.pose_graph_optimize(**ring, params=pd))
    cpu_d = pgo.pose_graph_optimize(
        **{k: v.cpu() for k, v in ring.items()}, params=pd)
    n = len(gt_d)

    def ate(ps):
        return float(np.sqrt(np.mean(np.sum(
            (ps.double().cpu().numpy()[:n, 4:] - gt_d[:, 4:]) ** 2, 1))))

    c0, c1 = float(res_d.initial_cost), float(res_d.final_cost)
    ate0, ate1 = ate(ring["poses"]), ate(res_d.poses)
    ate1_cpu = ate(cpu_d.poses)
    d_cost = (abs(c0 - float(cpu_d.initial_cost)) / c0,
              abs(c1 - float(cpu_d.final_cost)) / max(c1, 1e-12))
    d_pose = float((res_d.poses.cpu() - cpu_d.poses).abs().max())
    # Poses are held to the CPU route after the first two LM iterations
    # (cost 69.3 -> 0.078). From there on the cost sits at its float32
    # resolution (about 1e-6 absolute: the residuals of poses 10 units from
    # the origin), steps of ~2e-4 are accepted or rejected by that rounding,
    # and the optimum is flat enough that two summation orders end up to
    # ~1.3e-3 apart in translation at equal cost. The whole solve is held
    # by its cost and by the ATE gate on both routes.
    pd2 = pgo.PGOParams(max_iterations=2)
    two_g = pgo.pose_graph_optimize(**ring, params=pd2)
    two_c = pgo.pose_graph_optimize(
        **{k: v.cpu() for k, v in ring.items()}, params=pd2)
    d_pose2 = float((two_g.poses.cpu() - two_c.poses).abs().max())
    pad_ok = torch.equal(res_d.poses[n:], ring["poses"][n:])
    log(f"backend PGO: {n} keyframes (bucket {ring['poses'].shape[0]}), "
        f"{int((ring['edge_weight'] > 0).sum())} edges (bucket "
        f"{ring['edge_i'].shape[0]}); cost {c0:.4f} -> {c1:.6f}; "
        f"translation ATE {ate0:.4f} -> {ate1:.4f} (CPU route "
        f"{ate1_cpu:.4f}); padding unchanged {pad_ok}; under sync debug "
        f"mode 'error'; card vs CPU: cost rel {d_cost[0]:.3e} / "
        f"{d_cost[1]:.3e}, poses after 2 iterations {d_pose2:.3e} (bound: "
        f"1e-4, 0.05, 1e-3), poses after {pd.max_iterations} {d_pose:.3e} "
        f"(not held: float32 resolution of the optimum) [{card_line}]")
    if not (c1 < 0.5 * c0 and ate1 < 0.75 * ate0 and ate1_cpu < 0.75 * ate0
            and pad_ok):
        raise AssertionError(
            f"backend PGO: cost or ATE not reduced enough (cost {c0} -> "
            f"{c1}, ATE {ate0} -> {ate1}, CPU route {ate1_cpu}, padding "
            f"unchanged {pad_ok})")
    if not (d_cost[0] <= 1e-4 and d_cost[1] <= 0.05 and d_pose2 <= 1e-3):
        raise AssertionError(
            f"backend PGO: card and CPU route differ (cost rel {d_cost}, "
            f"poses after 2 iterations {d_pose2})")
    out["pgo"] = {"initial_cost": c0, "final_cost": c1,
                  "ate": [ate0, ate1], "cpu_ate": ate1_cpu,
                  "cpu_cost_rel": d_cost, "cpu_pose_2_iterations": d_pose2,
                  "cpu_pose": d_pose,
                  **solve_times("PGO 256", lambda: pgo.pose_graph_optimize(
                      **ring, params=pd), pd.max_iterations, card_line,
                      device_reps=None)}

    out["case_end_s"].append(time.perf_counter() - t_phase)
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    only(launches, {})          # BA and PGO run no hand kernel

    # (e) loop detection
    rng = np.random.default_rng(SEED)
    texs = scene_textures()
    ocfg = orb.OrbConfig()
    descs = []
    for rot, origin in ((np.eye(3), np.zeros(3)), VIEW2, VIEW3):
        f = orb.orb_detect_and_describe(render_view(rot, origin, texs), ocfg,
                                        device="cuda")
        descs.append(slam._pack(f.descriptors[f.mask]).cpu().numpy())
    orb_desc = np.concatenate(descs)

    def flip(d, p):
        bits = np.unpackbits(d, axis=1)
        return np.packbits(bits ^ (rng.random(bits.shape) < p), axis=1)

    pool = np.concatenate([orb_desc] + [flip(orb_desc, 0.05)
                                        for _ in range(3)])
    t0 = time.perf_counter()
    vocab = bow.Vocabulary.build(pool, k=10, depth=4, seed=SEED,
                                 device="cuda")
    build_s = time.perf_counter() - t0
    db = bow.BowDatabase(vocab)
    kfs = [flip(pool[rng.choice(len(pool), 1000, replace=False)], 0.03)
           for _ in range(50)]
    t0 = time.perf_counter()
    for d in kfs:
        db.add(d)
    add_ms = (time.perf_counter() - t0) * 1e3 / len(kfs)
    target = 17
    query = flip(kfs[target], 0.02)
    t0 = time.perf_counter()
    hits = db.query(query, top_k=3)
    query_ms = (time.perf_counter() - t0) * 1e3
    every = np.concatenate(kfs + [query])
    words_g, wt_g = vocab.transform_words(every)
    cpu_vocab = bow.Vocabulary(vocab.k, vocab.depth, vocab.children,
                               vocab.node_desc, vocab.word_id,
                               vocab.word_weight, device="cpu")
    words_c, wt_c = cpu_vocab.transform_words(every)
    same = bool(np.array_equal(words_g, words_c)
                and np.array_equal(wt_g, wt_c))
    log(f"backend bow: vocabulary k {vocab.k}, depth {vocab.depth} from "
        f"{len(pool)} descriptors ({len(orb_desc)} ORB of views 1-3 and 3 "
        f"bit-flipped copies): {vocab.n_words} words, built in {build_s:.2f} "
        f"s on the host (idf on the card); 50 keyframes x 1000 added at "
        f"{add_ms:.2f} ms each; query of keyframe {target} (2% of bits "
        f"flipped), top 3: {[(h.entry_id, round(h.score, 4)) for h in hits]} "
        f"in {query_ms:.2f} ms; word ids of {len(every)} descriptors card "
        f"== CPU route: {same} [{card_line}]")
    if not (hits and hits[0].entry_id == target and same):
        raise AssertionError("backend bow: wrong keyframe ranked first, or "
                             "card word ids differ from the CPU route's")
    out["case_end_s"].append(time.perf_counter() - t_phase)
    x1000 = torch.as_tensor(kfs[0], device=DEV)
    tree = vocab._device_tree()

    def descend():
        return bow.vocabulary._descend(*tree, x1000, vocab.depth)

    out["bow"] = {"descriptors": len(pool), "words": vocab.n_words,
                  "build_s": build_s, "add_ms": add_ms,
                  "query_ms": query_ms, "top3": [(h.entry_id, h.score)
                                                 for h in hits],
                  "cpu_route_equal": same,
                  "descend_1000": {"call_ms": cuda_ms(descend),
                                   "device_ms": device_ms(descend)}}
    log(f"backend bow descent of 1000 descriptors: call "
        f"{out['bow']['descend_1000']['call_ms']:.4f} ms, device "
        f"{out['bow']['descend_1000']['device_ms']:.4f} ms [{card_line}]")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"backend: {json.dumps(out)}")
    log(f"backend phase: {out['phase_s']:.1f} s; hand-kernel launches of "
        f"cases (a)-(d), counted from 0: {launches} (BA and PGO are plain "
        f"PyTorch, as the reference's are plain XLA)")
    return out


# --------------------------------------------------------------------------
# the ninth slice: the SLAM frame loop
# --------------------------------------------------------------------------

SLAM_FRAMES = 40
SLAM_STEP = 0.08           # camera travel a frame: ~7 px of parallax at depth 5
# the loop thresholds of tests/test_slam.py's image-level loop test
SLAM_LOOP_CFG = dict(keyframe_min_interval=2, loop_min_kf_gap=8,
                     loop_min_score=0.10, loop_min_matches=15)
# keyframe ATE RMSE gate: 2.9x the worst of slam_spread.py's 5 card runs
# (0.00693; NVIDIA H100 80GB HBM3, 700 W)
SLAM_ATE_BOUND = 0.02
SLAM_KINDS = ("bootstrap", "tracked", "keyframe", "loop closure")


def slam_sequence(seed: int = SEED, n: int = SLAM_FRAMES):
    """``n`` 480×752 u8 frames of the two-plane scene (planes at depth
    2.7-5) on an out-and-back path: the camera moves SLAM_STEP along x
    (and 1/8 of it along y) a frame for n/2 frames and comes back, turning
    0.004 rad about y every frame, so the return revisits the start;
    Gaussian noise of σ 2 grey levels on each frame (as in
    tests/test_slam.py's image loop test). Returns (frames, gt (n, 7)
    world→camera poses, gt camera centres (n, 3))."""
    rng = np.random.default_rng(seed + 1)
    texs = scene_textures(seed)
    frames, poses, centres = [], [], []
    for i in range(n):
        s = i if i < n // 2 else n - 1 - i
        rot = _rot_xyz([0.0, np.degrees(0.004 * i), 0.0])
        origin = np.array([SLAM_STEP * s, SLAM_STEP / 8 * s, 0.0])
        img = render_view(rot, origin, texs).astype(np.float64)
        frames.append(np.clip(np.round(img + rng.normal(0, 2.0, img.shape)),
                              0, 255).astype(np.uint8))
        poses.append(np.concatenate([_quat_np(rot), -rot @ origin]))
        centres.append(origin)
    return frames, np.stack(poses), np.stack(centres)


def slam_vocabulary(frames, device):
    """The port's vocabulary (k 8, depth 3, seed 1) from the ORB of every
    6th frame at SlamConfig()'s ORB widths, as tests/test_slam.py builds
    it from its sequence."""
    scfg = slam.SlamConfig()
    ocfg = orb.OrbConfig(n_features=scfg.n_features, n_levels=scfg.n_levels)
    descs = []
    for f in frames[::6]:
        feats = orb.orb_detect_and_describe(f, ocfg, device=device)
        descs.append(slam._pack(feats.descriptors[feats.mask]).cpu().numpy())
    return bow.Vocabulary.build(np.concatenate(descs), k=8, depth=3, seed=1,
                                device=device)


def frame_kinds(results):
    """Each frame's kind: bootstrap (the frames up to and including the
    one that initialises), loop closure, keyframe, or tracked (the rest,
    lost frames too)."""
    kinds, booting = [], True
    for r in results:
        if booting:
            kinds.append("bootstrap")
            booting = r.state == slam.TrackingState.INITIALIZING
        elif r.loop_closed_with is not None:
            kinds.append("loop closure")
        elif r.is_keyframe:
            kinds.append("keyframe")
        else:
            kinds.append("tracked")
    return kinds


def slam_ate(system, centres, device) -> float:
    """Keyframe ATE RMSE: the keyframes' camera centres against the truth
    after a sim3 alignment (the port's evaluate)."""
    est = slam_eval.poses7_to_t44(system.trajectory(), invert=True,
                                  device=device)[:, :3, 3]
    gt = centres[[kf.frame_idx for kf in system.map.keyframes]]
    return slam_eval.absolute_trajectory_error(est, gt).rmse


def run_slam(frames, vocab, device, per_frame=None, stages=None,
             seed: int = SEED, mesh=None):
    """``MonocularSlam`` with SlamConfig() widths, the loop thresholds and
    draws seeded with ``seed`` over ``frames`` (host u8 arrays, as a
    camera hands them over). Returns (system, call ms per frame).
    ``per_frame(i, fn)`` runs each frame's call (default: just the call);
    ``stages``: a dict that collects the host ms of each call of the
    loop's stages (each ends in a read-back, so its host time covers its
    device work). ``mesh``: MonocularSlam's (this process is rank 0)."""
    system = slam.MonocularSlam(
        K_EUROC, slam.SlamConfig(**SLAM_LOOP_CFG, seed=seed),
        vocabulary=vocab, device=device, mesh=mesh)
    if stages is not None:
        for name in ("_extract", "_initialize", "_track", "_triangulate_new",
                     "_local_ba", "_try_loop_closure", "_run_pgo",
                     "global_ba"):
            fn = getattr(system, name)

            def timed(*a, _fn=fn, _name=name, **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    stages.setdefault(_name, []).append(
                        (time.perf_counter() - t0) * 1e3)

            setattr(system, name, timed)
    ms = []
    for i, f in enumerate(frames):
        def call(f=f):
            return system.process_frame(f)
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        if per_frame is None:
            call()
        else:
            per_frame(i, call)
        if device != "cpu":
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return system, ms


def slam_summary(system, ms, centres, device) -> dict:
    """What the ground-truth gates read: states, keyframes, loops, ATE."""
    res = system.results
    loops = [(r.frame_idx, r.loop_closed_with) for r in res
             if r.loop_closed_with is not None]
    return {"frames": len(res),
            "tracked": sum(r.pose is not None for r in res),
            "final_state": system.state.value,
            "bootstrap_frame": next((r.frame_idx for r in res
                                     if r.state != slam.TrackingState
                                     .INITIALIZING), None),
            "keyframes": len(system.map.keyframes),
            "map_points": int(system.map.point_valid.sum()),
            "loop_edges": sum(e[3] > 1.0 for e in system.map.edges),
            "loops": loops,
            "ate_rmse": slam_ate(system, centres, device)
            if len(system.map.keyframes) >= 3 else float("nan"),
            "loop_s": sum(ms) / 1e3}


def slam_gates(s: dict, ate_bound: float = SLAM_ATE_BOUND) -> list:
    """The ground-truth gates a run must pass; returns the failed ones."""
    failed = []
    if s["final_state"] != "tracking":
        failed.append(f"final state {s['final_state']}")
    if s["tracked"] < 0.7 * s["frames"]:
        failed.append(f"tracked {s['tracked']} of {s['frames']} < 70%")
    if s["keyframes"] < 5:
        failed.append(f"{s['keyframes']} keyframes < 5")
    if not any(old < 8 for _, old in s["loops"]):
        failed.append(f"no loop closed to a keyframe < 8: {s['loops']}")
    if not s["ate_rmse"] < ate_bound:
        failed.append(f"keyframe ATE {s['ate_rmse']} >= {ate_bound}")
    return failed


def _frame_trace(call, count_syncs: bool = True):
    """One frame under torch.profiler (CUPTI records only) and sync debug
    mode "warn": (result, {host wall ms, kernel launches and copies
    enqueued, device records, device busy ms, host synchronisations and
    the Python line of each}). ``count_syncs`` False: no sync debug mode
    (syncs None).
    The trace is read from its raw records (building a FunctionEvent for
    each of a frame's ~10^4-10^5 records takes seconds); the tracer loses
    a session's first few device records, so busy time is a slight
    underestimate (the count lost is reported)."""
    import warnings
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.set_sync_debug_mode("warn" if count_syncs else 0)
            t0 = time.perf_counter()
            try:
                out = call()
                torch.cuda.synchronize()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            wall = (time.perf_counter() - t0) * 1e3
    sites = [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
             if "called a synchronizing" in str(w.message)]
    tr = {"wall_ms": wall, "launches": 0, "copies": 0, "device_records": 0,
          "busy_ms": 0.0, "syncs": len(sites) if count_syncs else None,
          "sync_sites": sites}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            tr["device_records"] += 1
            tr["busy_ms"] += e.duration_ns() / 1e6
        elif e.name().startswith(("cudaLaunch", "cuLaunch")):
            tr["launches"] += 1
        elif e.name().startswith(_ENQUEUES[2:]):
            tr["copies"] += 1
    return out, tr


def _pct(vals, q):
    return float(np.percentile(np.asarray(vals, np.float64), q))


def phase_slam(card_line):
    """The SLAM frame loop at full width: ``MonocularSlam.process_frame``
    over SLAM_FRAMES 480×752 frames of an out-and-back path (K_EUROC,
    SlamConfig() widths, the image loop test's loop thresholds, a
    vocabulary built by the port from the sequence). Counted from 0 after
    the vocabulary: K1 1, K2 2, K3 1 a frame and no other kernel; the K1-K3
    calls of the first and last frames held to their plain versions;
    ground-truth gates (slam_gates). Then the same loop again, each frame
    under the profiler and sync debug mode "warn", for launches,
    synchronisations and device busy time per frame kind."""
    t_phase = time.perf_counter()
    frames, gt, centres = slam_sequence()
    t_render = time.perf_counter() - t_phase
    vocab = slam_vocabulary(frames, "cuda")
    # warm-up: bootstrap and a few tracked frames (cuBLAS, allocator)
    run_slam(frames[:4], vocab, "cuda")
    recs = [Record(name) for name in ("fast_harris_levels", "windows_paired",
                                      "brief_rotated")]
    last = len(frames) - 1

    def per_frame(i, call):
        if i in (0, last):
            with recs[0], recs[1], recs[2]:
                return call()
        return call()

    stages = {}
    (system, ms), launches = counted(
        lambda: run_slam(frames, vocab, "cuda", per_frame, stages))
    n = len(frames)
    log(f"slam: launches over {n} frames {launches}")
    only(launches, {"fast_harris": n, "windows_paired": 2 * n,
                    "brief_rotated": n})
    errs = check_track_kernels(*recs, label="slam")
    summ = slam_summary(system, ms, centres, "cuda")
    kinds = frame_kinds(system.results)
    failed = slam_gates(summ)
    log(f"slam: {json.dumps(summ)} [{card_line}]")
    log("slam frames (index:kind initial, - without a pose/n_tracked): "
        + " ".join(
        f"{r.frame_idx}:{k[0]}{'' if r.pose is not None else '-'}"
        f"/{r.n_tracked}" for r, k in zip(system.results, kinds)))
    out = {"summary": summ, "render_s": t_render, "frame_ms": ms,
           "kinds": kinds, "kernel_errs": errs, "by_kind": {}}
    for kind in SLAM_KINDS:
        vals = [m for m, k in zip(ms, kinds) if k == kind]
        if vals:
            out["by_kind"][kind] = {"frames": len(vals),
                                    "call_ms_p50": _pct(vals, 50),
                                    "call_ms_p95": _pct(vals, 95)}
    out["frames_per_s"] = n / summ["loop_s"]
    out["stages_ms"] = {k: {"calls": len(v), "total": sum(v),
                            "p50": _pct(v, 50)} for k, v in stages.items()}
    for name, st in out["stages_ms"].items():
        log(f"slam stage {name}: {st['calls']} calls, {st['total']:.1f} ms "
            f"in all, p50 {st['p50']:.2f} ms (host wall) [{card_line}]")

    # the same loop again, each frame traced
    traces = []

    def traced(i, call):
        res, tr = _frame_trace(call)
        traces.append(tr)
        return res

    t0 = time.perf_counter()
    system2, _ = run_slam(frames, vocab, "cuda", traced)
    t_traced = time.perf_counter() - t0
    kinds2 = frame_kinds(system2.results)
    for kind in SLAM_KINDS:
        sel = [tr for tr, k in zip(traces, kinds2) if k == kind]
        if not sel:
            continue
        row = out["by_kind"].setdefault(kind, {})
        row.update({
            "traced_frames": len(sel),
            "launches_per_frame": float(np.mean([t["launches"] for t in sel])),
            "copies_per_frame": float(np.mean([t["copies"] for t in sel])),
            "syncs_per_frame": float(np.mean([t["syncs"] for t in sel])),
            "busy_share": sum(t["busy_ms"] for t in sel)
            / sum(t["wall_ms"] for t in sel)})
    wall = sum(t["wall_ms"] for t in traces)
    out["device_share"] = sum(t["busy_ms"] for t in traces) / wall
    sites = {}
    for tr in traces:
        for site in tr.pop("sync_sites"):
            sites[site] = sites.get(site, 0) + 1
    out["sync_sites"] = dict(sorted(sites.items(), key=lambda kv: -kv[1]))
    log(f"slam host syncs over the traced sequence by Python line: "
        f"{json.dumps(dict(list(out['sync_sites'].items())[:16]))}")
    out["traced"] = {"wall_s": wall / 1e3, "phase_s": t_traced,
                     "lost_device_records": sum(
                         t["launches"] + t["copies"] - t["device_records"]
                         for t in traces),
                     "summary": slam_summary(system2, [wall], centres,
                                             "cuda")}
    for kind, row in out["by_kind"].items():
        log(f"slam {kind}: {row.get('frames', 0)} frames, call ms p50 "
            f"{row.get('call_ms_p50', float('nan')):.2f} / p95 "
            f"{row.get('call_ms_p95', float('nan')):.2f}; traced run: "
            f"{row.get('launches_per_frame', float('nan')):.0f} kernel "
            f"launches, {row.get('copies_per_frame', float('nan')):.1f} "
            f"copies, {row.get('syncs_per_frame', float('nan')):.1f} host "
            f"syncs a frame, device busy share "
            f"{row.get('busy_share', float('nan')):.4f} [{card_line}]")
    log(f"slam: {n} frames in {summ['loop_s']:.3f} s = "
        f"{out['frames_per_s']:.3f} frames/s; device busy share of the "
        f"traced sequence {out['device_share']:.4f}; map points "
        f"{summ['map_points']}, keyframes {summ['keyframes']}, loop edges "
        f"{summ['loop_edges']}, keyframe ATE RMSE {summ['ate_rmse']:.5f} "
        f"(gate < {SLAM_ATE_BOUND}) [{card_line}]")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"slam: {json.dumps(out)}")
    log(f"slam phase: {out['phase_s']:.1f} s (render {t_render:.1f} s, "
        f"traced run {t_traced:.1f} s)")
    if failed:
        raise AssertionError(f"slam: ground-truth gates failed: {failed}")
    return launches, errs, summ


# --------------------------------------------------------------------------
# the fourteenth slice: the distributed layer on ranks that share the card
# --------------------------------------------------------------------------

PAR_RANKS = 4
PAR_BA_ITERS = slam.SlamConfig().global_ba_iterations     # 12
# the reference's own bounds for a distributed against a single-host
# solve (tests/test_ba_dist.py:33-43)
PAR_BA_TOL = {"cost": 1e-3, "poses": 5e-4, "points": 5e-3}
PAR_PGO_TOL = 1e-3          # poses after 2 iterations: the backend gate
PAR_TIMEOUT = 420.0         # seconds for one spawn of the ranks
PAR_HOT = 1500              # tests/test_parallel2.py's hot pair
PAR_DEVICE = "cuda:0"       # every rank's device: the one card


def skewed_traffic(seed: int = SEED):
    """tests/test_parallel2.py:162-225's skewed co-visibility on PAR_RANKS
    shards: PAR_HOT observations from shard 1 of points of shard 3, 6
    between every other pair, 10 points a shard."""
    d, hot, cold, per = PAR_RANKS, PAR_HOT, 6, 10
    rng = np.random.default_rng(seed)
    src, cam = [1] * hot, list(rng.integers(0, 4, hot))
    pt = list(rng.integers(3 * per, 4 * per, hot))
    for s in range(d):
        for t in range(d):
            if (s, t) != (1, 3):
                src += [s] * cold
                cam += list(rng.integers(0, 4, cold))
                pt += list(rng.integers(t * per, (t + 1) * per, cold))
    uv = rng.random((len(src), 2)).astype(np.float32)
    return (np.asarray(src), np.asarray(cam, np.int32), np.asarray(pt), uv,
            d, per), {}


def parallel_inputs(d, frames, centres=None):
    """The phase's host inputs for a ``d``-rank mesh: the front end's
    frames, the exchange plans, the BA configurations in both layouts
    (the PCG one on more than one rank), the PGO ring, and with
    ``centres`` the SLAM sequence. Returns (inputs, the BA problems, the
    ring on the CPU, its true poses)."""
    problems = {
        "dense 170x3000": synth_ba_problem(170, 3000, 1, 0.2, "cpu"),
        "pcg 600x8000": synth_ba_problem(600, 8000, 1, 0.0375, "cpu")}
    if d == 1:
        problems.pop("pcg 600x8000")
    params = ba.BAParams(max_iterations=PAR_BA_ITERS, loss="huber",
                         loss_scale=2.0)
    bas = {}
    for name, (prob, m) in problems.items():
        bas[name] = {"observations": m,
                     "colo": ba_dist.shard_problem(prob, d),
                     "kf": ba_dist.shard_problem_by_keyframe(prob, d)}
    plans = {mode: ba_dist.keyframe_exchange_plan(
        problems["dense 170x3000"][0], d, mode=mode)
        for mode in ("a2a", "rounds")}
    if d == PAR_RANKS:
        plans["skewed"] = exchange.build_exchange_plan(*skewed_traffic()[0])
    ring, gt = pgo_ring("cpu")
    ring_np = {k: v.numpy() for k, v in ring.items()}
    pgo_sharded = pgo_dist.shard_pgo(
        ring_np["poses"], ring_np["edge_i"], ring_np["edge_j"],
        ring_np["edge_meas"], ring_np["edge_weight"], fixed=ring_np["fixed"],
        n_devices=d)
    return {"frames": np.stack(frames[:PAR_RANKS]), "plans": plans,
            "ba": bas, "ba_params": params, "pgo": pgo_sharded,
            "pgo_iters": (2, 15) if d > 1 else (2,),
            "slam": None if centres is None else (frames, centres)
            }, problems, ring, gt


def _rank_traced(fn, mesh, trace: bool = True):
    """``fn`` on every rank (the collectives need every rank), timed by
    the host clock; with ``trace`` first once more, traced on rank 0
    (``_frame_trace``: launches, copies, device busy ms; host syncs only
    over NCCL — a gloo collective on CUDA tensors waits for the device in
    gloo's own thread, which sync debug mode reports on stderr, once a
    collective), which also warms up. A trace of 10^4 launches takes
    seconds to read, so one item of each shape is traced. Returns
    (result, host wall ms, rank 0's trace or NaNs)."""
    tr = {"busy_ms": float("nan"), "launches": float("nan"), "syncs": None}
    if trace and mesh.rank == 0:
        _, tr = _frame_trace(fn, torch.distributed.get_backend() == "nccl")
        tr.pop("sync_sites")
    elif trace:
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, tr


def _collectives(mesh, fn):
    """(fn's result, collectives and bytes it made on this rank)."""
    c0, b0 = mesh.counts["collectives"], mesh.counts["bytes"]
    out = fn()
    return out, (mesh.counts["collectives"] - c0,
                 mesh.counts["bytes"] - b0)


def _np(t):
    return t.detach().cpu().numpy()


def parallel_rank(mesh, inputs):
    """What each rank of the phase runs, on ``mesh.device``; returns its
    numbers and results as host values."""
    out = {"rank": mesh.rank, "backend": torch.distributed.get_backend(),
           "device": str(mesh.device), "stage_s": {}}
    t0 = time.perf_counter()
    # the sharded front end: B frames, B / D a rank, K1-K3 held to their
    # plain versions on the calls the path made
    frames, cfg = inputs["frames"], orb.OrbConfig()
    per = len(frames) // mesh.size
    orb.orb_detect_and_describe(frames[0], cfg, device=mesh.device)
    recs = [Record(name) for name in ("fast_harris_levels", "windows_paired",
                                      "brief_rotated")]
    with recs[0], recs[1], recs[2]:
        (feats, coll), launches = counted(lambda: _collectives(
            mesh, lambda: frontend_dist.detect_and_describe_batch(
                frames, cfg, mesh)))
    only(launches, {"fast_harris": per, "windows_paired": 2 * per,
                    "brief_rotated": per})
    out["front"] = {"launches": launches, "collectives": coll,
                    "features": [_np(f) for f in feats],
                    "kernel_errs": check_track_kernels(
                        *recs, label=f"parallel rank {mesh.rank} "
                                     f"frontend_dist")}
    out["front"]["call_ms"] = cuda_ms(
        lambda: frontend_dist.detect_and_describe_batch(frames, cfg, mesh),
        reps=5, warmup=1)

    out["stage_s"]["front"] = time.perf_counter() - t0
    # the exchange: every shard's received rows equal the host plan's
    out["exchange"] = {}
    for name, plan in inputs["plans"].items():
        (fields, coll), wall, _ = _rank_traced(lambda: _collectives(
            mesh, lambda: exchange.exchange_observations(plan, mesh)), mesh,
            trace=False)
        for dd in range(mesh.size):
            want = torch.as_tensor(exchange.host_receive_order(
                plan, dd, mesh.size))
            if not (torch.equal(fields[0][dd].cpu(), want[:, 0].int())
                    and torch.equal(fields[1][dd].cpu(), want[:, 1].int())
                    and torch.equal(fields[2][dd].cpu(), want[:, 2:4])
                    and torch.equal(fields[3][dd].cpu(), want[:, 4])):
                raise AssertionError(f"exchange {name}: shard {dd}'s rows "
                                     "differ from host_receive_order")
        out["exchange"][name] = {
            "mode": plan.mode, "payload_bytes": plan.payload_bytes,
            "collectives": coll[0], "bytes": coll[1], "call_ms": wall}

    out["stage_s"]["exchange"] = time.perf_counter() - t0
    # the summed Schur BA, both configurations, both layouts
    params = inputs["ba_params"]
    out["ba"] = {}
    for name, item in inputs["ba"].items():
        for layout in ("colo", "kf"):
            sharded = item[layout]
            fn = (ba_dist.bundle_adjust_schur_dist if layout == "colo"
                  else ba_dist.bundle_adjust_schur_dist_kf)
            (res, coll), wall, tr = _rank_traced(lambda: _collectives(
                mesh, lambda: fn(sharded, mesh, params)), mesh,
                trace=layout == "colo")
            n_ex = 0
            if layout == "kf":
                n_ex = 1 if sharded.mode == "a2a" else sum(
                    r % mesh.size != 0 for r in sharded.rounds)
            it = params.max_iterations
            out["ba"][f"{name} {layout}"] = {
                "mode": ba_dist._solver_mode(params, sharded.poses.shape[0],
                                             sharded.points.shape[1]),
                "initial_cost": float(res.initial_cost),
                "final_cost": float(res.final_cost),
                "poses": _np(res.poses), "points": _np(res.points),
                "call_ms": wall, "call_ms_per_iter": wall / it,
                "device_ms_per_iter": tr["busy_ms"] / it,
                "launches_per_iter": tr["launches"] / it,
                "syncs": tr["syncs"], "collectives": coll[0],
                "collectives_per_iter": (coll[0] - 2 - n_ex) / it,
                "bytes_per_iter": coll[1] / it, "exchange": n_ex}

    out["stage_s"]["ba"] = time.perf_counter() - t0
    # PGO over edge shards: 2 iterations (held to the single process) and
    # 15 (the solve the loop runs)
    out["pgo"] = {}
    for it in inputs["pgo_iters"]:
        pp = pgo.PGOParams(max_iterations=it)
        (res, coll), wall, tr = _rank_traced(lambda: _collectives(
            mesh, lambda: pgo_dist.pose_graph_optimize_dist(
                inputs["pgo"], mesh, pp)), mesh, trace=it == 2)
        out["pgo"][it] = {"poses": _np(res.poses),
                          "initial_cost": float(res.initial_cost),
                          "final_cost": float(res.final_cost),
                          "call_ms": wall, "call_ms_per_iter": wall / it,
                          "device_ms_per_iter": tr["busy_ms"] / it,
                          "launches_per_iter": tr["launches"] / it,
                          "syncs": tr["syncs"], "collectives": coll[0],
                          "bytes_per_iter": coll[1] / it}

    out["stage_s"]["pgo"] = time.perf_counter() - t0
    # MonocularSlam(mesh=): rank 0 runs the loop and leads each
    # distributed solve; the others follow
    if inputs["slam"] is not None:
        frames, centres = inputs["slam"]
        if mesh.rank == 0:
            vocab = slam_vocabulary(frames, mesh.device)
            c0 = mesh.counts["collectives"]
            leads = []
            lead = parallel.controller.lead
            parallel.controller.lead = lambda *a: leads.append(a[1]) or \
                lead(*a)
            try:
                (system, ms), launches = counted(lambda: run_slam(
                    frames, vocab, mesh.device, mesh=mesh))
            finally:
                parallel.controller.lead = lead
            parallel.controller.stop(mesh)
            out["slam"] = {"launches": launches, "leads": leads,
                           "collectives": mesh.counts["collectives"] - c0,
                           "summary": slam_summary(system, ms, centres,
                                                   mesh.device)}
        else:
            out["slam"] = {"jobs": parallel.follow(mesh)}
        out["stage_s"]["slam"] = time.perf_counter() - t0
    return out


def _device(row, per: str) -> str:
    """Rank 0's traced figures of a solve, or why there are none."""
    if row["device_ms_per_iter"] != row["device_ms_per_iter"]:
        return ("device, launches and host syncs: not traced (one solve "
                "of each shape is)")
    syncs = ("not counted (a gloo collective waits for the device in "
             "gloo's own thread)" if row["syncs"] is None
             else str(row["syncs"]))
    return (f"device {row['device_ms_per_iter']:.3f} ms and "
            f"{row['launches_per_iter']:.0f} launches {per} (rank 0), host "
            f"syncs a solve {syncs}")


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _check_ranks(label, ranks, key):
    """Every rank's poses (and points) of ``key`` bit-equal to rank 0's."""
    ref = ranks[0]
    for r in ranks[1:]:
        a, b = key(r), key(ref)
        for x, y in zip(a, b):
            if not np.array_equal(x, y):
                raise AssertionError(f"{label}: rank {r['rank']} differs "
                                     "from rank 0")


def phase_parallel(card_line, slam_summ):
    """The distributed layer (``kornia_tpu_torch.parallel``) on the card:
    (a) one rank over NCCL, the one-card deployment, and (b) 4 ranks that
    share the card over gloo, spawned by ``parallel.mesh.spawn``. Each
    runs the sharded front end (4 SLAM frames, ``OrbConfig()``), the
    exchange (the Dense configuration's keyframe layout in a2a and rounds
    mode; on 4 ranks also the hot pair), the summed Schur BA on the Dense
    (chol) and — on 4 ranks — the PCG (cg_dense) configuration in both
    layouts (12 iterations, Huber 2), PGO on the 256-keyframe ring (2 and
    15 iterations), and on 4 ranks ``MonocularSlam(mesh=)`` over the 40
    SLAM frames. Gates: front-end features bit-equal to the single
    process's, K1/K2/K3 1/2/1 a frame on every rank and bit-equal to their
    plain versions; received rows equal to the plan's; BA within
    PAR_BA_TOL of the single-process solve; PGO after 2 iterations within
    PAR_PGO_TOL of the single process's, after 15 the backend's cost and
    ATE gates; the SLAM run the slam phase's gates and loop count; every
    rank's results bit-equal. Returns what the kernels line reads."""
    t_phase = time.perf_counter()
    frames, _, centres = slam_sequence()
    t_render = time.perf_counter() - t_phase
    cfg = orb.OrbConfig()
    single_feats = [orb.orb_detect_and_describe(f, cfg, device=DEV)
                    for f in frames[:PAR_RANKS]]
    kern = {"front": {}, "errs": {}, "slam": None}
    runs = (("nccl, 1 rank", 1, [PAR_DEVICE]),
            (f"gloo, {PAR_RANKS} ranks on one card", PAR_RANKS,
             [PAR_DEVICE] * PAR_RANKS))
    single, failed = {}, []
    for label, d, devices in runs:
        t0 = time.perf_counter()
        inputs, problems, ring, gt_ring = parallel_inputs(
            d, frames, centres if d > 1 else None)
        params = inputs["ba_params"]
        for name, (prob, m) in problems.items():
            if name not in single:
                res = ba.bundle_adjust_schur(_problem_to(prob, DEV), params)
                single[name] = {k: _np(getattr(res, k)) for k in
                                ("poses", "points", "initial_cost",
                                 "final_cost")}
        ring_d = {k: v.to(DEV) for k, v in ring.items()}
        for it in (2, 15):
            if ("pgo", it) not in single:
                single[("pgo", it)] = _np(pgo.pose_graph_optimize(
                    **ring_d, params=pgo.PGOParams(max_iterations=it)).poses)
        t_inputs = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = parallel.mesh.spawn(parallel_rank, d, inputs,
                                    devices=devices, timeout=PAR_TIMEOUT)
        t_ranks = time.perf_counter() - t0
        tag = f"parallel ({label})"
        # initialize_distributed's rule: NCCL when each rank owns a card
        want_backend = "nccl" if d <= torch.cuda.device_count() else "gloo"
        if {(r["backend"], r["device"]) for r in ranks} != {
                (want_backend, PAR_DEVICE)}:
            raise AssertionError(f"{tag}: ranks on "
                                 f"{[(r['backend'], r['device']) for r in ranks]}")

        # front end
        for r in ranks:
            for i, name in enumerate(orb.OrbFeatures._fields):
                want = np.stack([_np(getattr(f, name))
                                 for f in single_feats])
                if not np.array_equal(r["front"]["features"][i], want):
                    raise AssertionError(f"{tag}: rank {r['rank']}'s "
                                         f"{name} differ from the single "
                                         "process's ORB")
            for k, v in r["front"]["kernel_errs"].items():
                kern["errs"][k] = max(kern["errs"].get(k, 0.0), v)
        fr = ranks[0]["front"]
        if d > 1:
            kern["front"] = {k: v for k, v in fr["launches"].items() if v}
        log(f"{tag} front end: {len(frames[:PAR_RANKS])} frames 480x752, "
            f"{len(frames[:PAR_RANKS]) // d} a rank; launches a rank "
            f"{ {k: v for k, v in fr['launches'].items() if v} }, "
            f"collectives {fr['collectives'][0]} ({fr['collectives'][1]} "
            f"B); features of every rank bit-equal to the single process's; "
            f"call {fr['call_ms']:.2f} ms [{card_line}]")

        # exchange
        for name, ex in ranks[0]["exchange"].items():
            log(f"{tag} exchange {name}: mode {ex['mode']}, payload "
                f"{ex['payload_bytes']} B (all shards), collectives "
                f"{ex['collectives']} (with the gathering all-gather), "
                f"{ex['bytes']} B from rank 0, call {ex['call_ms']:.2f} ms; "
                f"every shard's rows equal the plan's [{card_line}]")

        # BA
        for key, b in ranks[0]["ba"].items():
            name = key.rsplit(" ", 1)[0]
            s = single[name]
            d_cost = (_rel(b["initial_cost"], float(s["initial_cost"])),
                      _rel(b["final_cost"], float(s["final_cost"])))
            d_pose = float(np.abs(b["poses"] - s["poses"]).max())
            d_pts = float(np.abs(b["points"] - s["points"]).max())
            _check_ranks(f"{tag} BA {key}", ranks,
                         lambda r: (r["ba"][key]["poses"],
                                    r["ba"][key]["points"]))
            log(f"{tag} BA {key}: {inputs['ba'][name]['observations']} "
                f"observations, mode {b['mode']}, cost "
                f"{b['initial_cost']:.4f} -> {b['final_cost']:.4f}; against "
                f"the single process: cost rel {d_cost[0]:.3e} / "
                f"{d_cost[1]:.3e}, poses {d_pose:.3e}, points {d_pts:.3e} "
                f"(bound {PAR_BA_TOL}); call {b['call_ms']:.1f} ms = "
                f"{b['call_ms_per_iter']:.2f} a LM iteration, "
                f"{_device(b, 'a LM iteration')}, "
                f"{b['collectives_per_iter']:.2f} collectives and "
                f"{b['bytes_per_iter']:.0f} B a LM iteration (+ the initial "
                f"cost, the closing all-gather and {b['exchange']} for the "
                f"exchange); ranks bit-equal [{card_line}]")
            want_mode = "chol" if name.startswith("dense") else "cg_dense"
            if b["mode"] != want_mode or b["collectives_per_iter"] != 2:
                failed.append(f"{tag} BA {key}: mode {b['mode']}, "
                              f"{b['collectives_per_iter']} collectives a "
                              "LM iteration")
            if not (d_cost[0] <= PAR_BA_TOL["cost"]
                    and d_cost[1] <= PAR_BA_TOL["cost"]
                    and d_pose <= PAR_BA_TOL["poses"]
                    and d_pts <= PAR_BA_TOL["points"]
                    and b["final_cost"] < 0.1 * b["initial_cost"]):
                failed.append(f"{tag} BA {key}: outside the bounds")

        # PGO
        n = len(gt_ring)

        def ate(ps):
            return float(np.sqrt(np.mean(np.sum(
                (ps[:n, 4:].astype(np.float64) - gt_ring[:, 4:]) ** 2, 1))))

        for it, g in ranks[0]["pgo"].items():
            _check_ranks(f"{tag} PGO {it}", ranks,
                         lambda r: (r["pgo"][it]["poses"],))
            d_pose = float(np.abs(g["poses"] - single[("pgo", it)]).max())
            ate0, ate1 = ate(_np(ring["poses"])), ate(g["poses"])
            log(f"{tag} PGO {it} iterations: cost {g['initial_cost']:.4f} "
                f"-> {g['final_cost']:.6f}, ATE {ate0:.4f} -> {ate1:.4f}, "
                f"poses against the single process {d_pose:.3e}"
                + (f" (bound {PAR_PGO_TOL})" if it == 2 else
                   " (not held: float32 resolution of the optimum)")
                + f"; call {g['call_ms']:.1f} ms = "
                f"{g['call_ms_per_iter']:.2f} a LM iteration, "
                f"{_device(g, 'a LM iteration')}, "
                f"collectives {g['collectives']}, {g['bytes_per_iter']:.0f} "
                f"B a LM iteration [{card_line}]")
            if it == 2 and d_pose > PAR_PGO_TOL:
                failed.append(f"{tag} PGO: poses after 2 iterations "
                              f"{d_pose} from the single process's")
            if it == 15 and not (g["final_cost"] < 0.5 * g["initial_cost"]
                                 and ate1 < 0.75 * ate0):
                failed.append(f"{tag} PGO: cost or ATE not reduced")
            if g["collectives"] != 1 + 2 * it:
                failed.append(f"{tag} PGO: {g['collectives']} collectives")

        # MonocularSlam(mesh=)
        if d > 1:
            sl = ranks[0]["slam"]
            summ = sl["summary"]
            jobs = [r["slam"]["jobs"] for r in ranks[1:]]
            only(sl["launches"], {"fast_harris": summ["frames"],
                                  "windows_paired": 2 * summ["frames"],
                                  "brief_rotated": summ["frames"]})
            kern["slam"] = {k: v for k, v in sl["launches"].items() if v}
            failed += [f"{tag} MonocularSlam(mesh=): {f}"
                       for f in slam_gates(summ)]
            if len(summ["loops"]) != len(slam_summ["loops"]):
                failed.append(f"{tag} MonocularSlam(mesh=): "
                              f"{len(summ['loops'])} loops, the slam phase "
                              f"{len(slam_summ['loops'])}")
            leads = sl["leads"]
            if (jobs != [len(leads)] * (d - 1)
                    or leads.count("pgo_dist") != len(summ["loops"])
                    or "ba_dist_kf" not in leads):
                failed.append(f"{tag} MonocularSlam(mesh=): rank 0 led "
                              f"{leads}, the followers joined {jobs}")
            log(f"{tag} MonocularSlam(mesh=): {json.dumps(summ)}; rank 0 "
                f"led {leads.count('pgo_dist')} PGO and "
                f"{leads.count('ba_dist_kf')} global BA solves, "
                f"{sl['collectives']} collectives; every follower joined "
                f"{jobs[0]} [{card_line}]")
        log(f"{tag}: inputs and single-process references "
            f"{t_inputs:.1f} s, ranks {t_ranks:.1f} s (spawn, imports and "
            f"every item; rank 0 done with each item at "
            f"{ {k: round(v, 1) for k, v in ranks[0]['stage_s'].items()} } "
            f"s after its start)")
    log(f"parallel phase: {time.perf_counter() - t_phase:.1f} s (render "
        f"{t_render:.1f} s)")
    if failed:
        raise AssertionError(f"parallel: gates failed: {failed}")
    return kern


def phase_host(card_line, parent=None):
    """Host microseconds per wrapper call (1000 calls, no synchronise) on
    the main path's recorded inputs, this tree's wrappers and, with
    --parent, the parent tree's, in turns (parent, new, new, parent).
    Returns {name: {"new": [..], "parent": [..]}}."""
    out = {}
    for name, call in HOST_CASES.items():
        # the parent's K5 has no broadcast mode
        mods = ([("parent", parent), ("new", ck), ("new", ck),
                 ("parent", parent)]
                if parent is not None and name != "lane_gather broadcast"
                else [("new", ck), ("new", ck)])
        t = {}
        for which, mod in mods:
            t.setdefault(which, []).append(host_us(lambda m=mod: call(m)))
        out[name] = t
        log(f"host {name}: " + ", ".join(
            f"{w} {[round(v, 2) for v in vals]}" for w, vals in t.items())
            + f" us per call [{card_line}]")
    return out


def phase_preprocess(card_line):
    """K6 at 1080p → 640×640, stretch and letterbox."""
    hh, ww = HW_1080P
    img = np.random.default_rng(SEED + 4).integers(0, 256, (hh, ww, 3),
                                                   np.uint8)
    x = torch.as_tensor(img, device=DEV)
    cfg = preprocess.PreprocessorConfig(
        out_size=(640, 640), normalize=preprocess.NormalizeMode.MEAN_STD,
        mean=IMAGENET_MEAN, std=IMAGENET_STD)
    pre = preprocess.Preprocessor(cfg, device=DEV)
    pre(x)                                           # warm-up
    out, launches = counted(lambda: pre(x))
    only(launches, {"preprocess": 1})
    if tuple(out.shape) != (1, 3, 640, 640) or out.dtype != torch.float32 \
            or not torch.isfinite(out).all():
        raise AssertionError("preprocess output")
    args = (x, 640, 640, IMAGENET_MEAN, IMAGENET_STD)
    HOST_CASES["preprocess"] = lambda mod: mod.fused_preprocess(*args)
    taps = ck._fused_preprocess_taps(*args)
    plain = ck._fused_preprocess_plain(*args)
    if not torch.equal(out[0], taps):
        raise AssertionError("preprocess differs from its own arithmetic in "
                             f"PyTorch ops: {max_err(out[0], taps)}")
    err = max_err(out[0], plain)
    ulp = float(((out[0] - plain).abs()
                 / torch.finfo(torch.float32).eps
                 / plain.abs().clamp(min=2.0 ** -126)).max())
    if err > PLAIN_TOL["preprocess"]:
        raise AssertionError(f"preprocess differs from its plain version: "
                             f"{err}")
    src = x.permute(2, 0, 1)[None].float().contiguous()
    scale, bias = (torch.as_tensor(a, device=DEV)[None, :, None, None]
                   for a in ck._norm_scale_bias(IMAGENET_MEAN, IMAGENET_STD))

    def lib_resize():
        return torch.nn.functional.interpolate(
            src, size=(640, 640), mode="bilinear", align_corners=False,
            antialias=False)

    def lib_all():
        t = torch.nn.functional.interpolate(
            x.permute(2, 0, 1)[None].float(), size=(640, 640),
            mode="bilinear", align_corners=False, antialias=False)
        return t * scale + bias

    lib_dev = max_err(lib_all()[0], plain)
    yi, _ = ck._resize_taps(hh, 640)
    xi, _ = ck._resize_taps(ww, 640)
    touched = np.zeros((hh, ww), bool)
    touched[np.ix_(np.unique(yi), np.unique(xi))] = True
    nbytes = (int(touched.sum()) * 3 + out.numel() * 4
              + (yi.size + xi.size) * 8)
    bms, by = bound(nbytes, f32_ops=out.numel() * 11)
    row = {"max_abs_err": err, "bound_ms": bms, "bound_by": by}
    row.update(kernel_times(lambda: ck.fused_preprocess(*args),
                            lambda: ck._fused_preprocess_plain(*args),
                            lib_resize))
    log(f"K6 preprocess ({hh}x{ww}x3 u8 -> 3x640x640 f32, ImageNet "
        f"mean/std): launches 1; bit-equal to the two-tap formula in "
        f"PyTorch ops; vs the plain version (dense f32 matmuls) max |diff| "
        f"{err:.3e} (largest relative {ulp:.2f} eps); "
        f"{fmt_times(row, 'F.interpolate on ready f32 NCHW')} "
        f"(with u8->f32, CHW and normalise device {device_ms(lib_all):.4f} "
        f"/ call {cuda_ms(lib_all):.4f} ms; max "
        f"|dev| from plain {lib_dev:.3e}), bound {bms:.5f} ms ({by}, "
        f"{nbytes} B); entry point {cuda_ms(lambda: pre(x)):.4f} ms "
        f"[{card_line}]")

    # 1920/640 = 3 and 1080/640 = 27/16: every tap weight above is a
    # multiple of 1/32, so all products are exact. A classifier's 224 x 224
    # has weights that are not: the dense products' rounding shows here.
    c224 = preprocess.PreprocessorConfig(
        out_size=(224, 224), normalize=preprocess.NormalizeMode.MEAN_STD,
        mean=IMAGENET_MEAN, std=IMAGENET_STD)
    o224, n224 = counted(
        lambda: preprocess.resize_normalize_to_tensor(x, c224, device=DEV))
    only(n224, {"preprocess": 1})
    a224 = (x, 224, 224, IMAGENET_MEAN, IMAGENET_STD)
    if not torch.equal(o224[0], ck._fused_preprocess_taps(*a224)):
        raise AssertionError("preprocess 224 differs from its own "
                             "arithmetic in PyTorch ops")
    p224 = ck._fused_preprocess_plain(*a224)
    e224 = max_err(o224[0], p224)
    if e224 > PLAIN_TOL["preprocess"]:
        raise AssertionError(f"preprocess 224 differs from its plain "
                             f"version: {e224}")
    log(f"K6 preprocess ({hh}x{ww}x3 u8 -> 3x224x224): launches 1; "
        f"bit-equal to the two-tap formula; vs the plain version max |diff| "
        f"{e224:.3e} on {float((o224[0] != p224).float().mean()):.4f} of the "
        f"values (tolerance {PLAIN_TOL['preprocess']:.0e}); kernel "
        f"{cuda_ms(lambda: ck.fused_preprocess(*a224)):.4f} ms, plain "
        f"{cuda_ms(lambda: ck._fused_preprocess_plain(*a224)):.4f} ms "
        f"[{card_line}]")
    row["max_abs_err"] = max(err, e224)

    lcfg = preprocess.PreprocessorConfig(
        out_size=(640, 640), resize_mode=preprocess.ResizeMode.LETTERBOX,
        normalize=preprocess.NormalizeMode.MEAN_STD, mean=IMAGENET_MEAN,
        std=IMAGENET_STD)
    lout, llaunch = counted(
        lambda: preprocess.resize_normalize_to_tensor(x, lcfg, device=DEV))
    only(llaunch, {"preprocess": 1})
    inner = ck._fused_preprocess_taps(x, 360, 640, IMAGENET_MEAN,
                                      IMAGENET_STD)
    if tuple(lout.shape) != (1, 3, 640, 640) or \
            not torch.equal(lout[0, :, 140:500, :], inner):
        raise AssertionError("letterbox interior (360 x 640 at row 140)")
    pad = torch.tensor([(lcfg.pad_value - mu) / sd for mu, sd in
                        zip(IMAGENET_MEAN, IMAGENET_STD)], device=DEV)
    border = torch.cat([lout[0, :, :140], lout[0, :, 500:]], dim=1)
    if float((border - pad[:, None, None]).abs().max()) > 1e-6:
        raise AssertionError("letterbox pad canvas")
    cpu = preprocess.resize_normalize_to_tensor(img, lcfg, device="cpu")
    log(f"preprocess letterbox (1080x1920 -> 360x640 on a 640x640 canvas): "
        f"launches 1, interior bit-equal to the two-tap formula, pad rows "
        f"equal (pad - mean)/std; max |card - cpu| "
        f"{max_err(lout.cpu(), cpu):.3e}; entry point "
        f"{cuda_ms(lambda: preprocess.resize_normalize_to_tensor(x, lcfg, device=DEV)):.4f}"
        f" ms [{card_line}]")
    row["launches"] = (launches["preprocess"] + n224["preprocess"]
                       + llaunch["preprocess"])
    return row


# --------------------------------------------------------------------------
# the tenth slice: the FAST detector path and the image-processing library
# --------------------------------------------------------------------------


def imgproc_frame(seed: int = SEED + 10) -> np.ndarray:
    """A 1080×1920×3 u8 frame of the 1080p configuration's size, textured
    so that it has corners and edges: 6-px blocks of seeded noise, plus
    pixel noise (σ 6)."""
    hh, ww = HW_1080P
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (hh // 6 + 1, ww // 6 + 1, 3)).astype(
        np.float32)
    up = np.repeat(np.repeat(base, 6, 0), 6, 1)[:hh, :ww]
    return np.clip(up + rng.normal(0, 6, up.shape), 0, 255).astype(np.uint8)


# card against the CPU route, by function: ("lsb", n) at most n apart,
# ("rel", x) at most x of the CPU output's largest magnitude (at least 1),
# ("share", x) at most a share x of the values differing; unnamed: integer
# outputs equal, float outputs ("rel", 1e-5). The card sums its reductions
# (means, nv12_from_rgb's 2×2 chroma mean) and matrix products in other
# orders than the CPU, and ATen divides a tensor by a Python number there
# as t·(1/c); u8 outputs of float32 pipelines may then round a .5 the
# other way.
IMGPROC_TOL = {
    **{name: ("lsb", 1) for name in (
        "hsv_to_rgb", "hls_to_rgb", "rgb_to_hsv", "rgb_to_hls", "rgb_to_luv",
        "luv_to_rgb", "yuv_to_rgb", "rgb_to_yuv", "sepia", "adjust_contrast",
        "adjust_saturation", "adjust_hue", "adjust_gamma", "bilateral_blur",
        "resize_fast nearest", "resize_fast bilinear", "resize_fast bicubic",
        "resize_fast lanczos", "resize_fast area", "resize lanczos antialias",
        "scale_pyramid", "otsu_threshold", "box_blur", "add_weighted",
        "adaptive_threshold mean", "adaptive_threshold gaussian",
        "nv12_from_rgb")},
    "canny": ("share", 1e-3),
    # the eleventh slice: jitter's means and hue and the affine matrix's
    # cos/sin in float32 on each device; the depth warp's map from a
    # float32 matmul
    "augmentation pipeline": ("lsb", 1),
    "augmentation apply_batch": ("lsb", 1),
    "warp_frame_depth": ("lsb", 1),
}


def imgproc_inputs(frame: np.ndarray) -> dict:
    """The chain's inputs, made once on the CPU (the same values go to the
    card): the frame, its gray, float forms, a second image, a mask, a
    filter and a structuring element, keypoints, a Bayer mosaic, video
    planes and each colour inverse's input."""
    rng = np.random.default_rng(SEED + 11)
    rgb = torch.as_tensor(frame)
    gray = color.rgb_to_gray(rgb, device="cpu")[..., 0]
    hh, ww = gray.shape
    d = {"rgb": rgb, "gray": gray, "rgbf": rgb.float() * (1.0 / 255.0),
         "b2": rgb.flip(0).contiguous(),
         "rgba": torch.cat([rgb, rgb[..., :1]], -1),
         "mask": (gray > 100).to(torch.uint8),
         "kernel": torch.as_tensor(rng.normal(size=(3, 3)).astype(
             np.float32)),
         "se": torch.tensor([[0, 1, 0], [1, 1, 1], [0, 1, 0]],
                            dtype=torch.uint8),
         "xy": torch.as_tensor(rng.uniform(0, [ww, hh], (FAST_MAX_KP, 2))
                               .astype(np.float32)),
         "off": torch.tensor([ww * 3 // 8, hh * 5 // 18]),
         "raw": bayer.mosaic(rgb, "rggb", device="cpu"),
         "y": gray, "uv": rgb[::2, ::2, :2].contiguous(),
         "u": rgb[::2, ::2, 0].contiguous(), "v": rgb[::2, ::2, 1].contiguous(),
         "packed": rgb[..., :2].reshape(hh, ww * 2).contiguous()}
    for fwd, kind in (("rgb_to_hsv", "rgb"), ("rgb_to_hls", "rgb"),
                      ("rgb_to_xyz", "rgbf"), ("rgb_to_lab", "rgbf"),
                      ("rgb_to_luv", "rgb"), ("rgb_to_yuv", "rgb")):
        d[fwd] = getattr(color, fwd)(d[kind], device="cpu")
    return d


def imgproc_chain(hh: int, ww: int):
    """(name, fn(inputs, device)): every public function of the slice's
    modules once, on an hh × ww frame."""
    pre = {m: preprocess.PreprocessorConfig(
        out_size=(640, 640), normalize=preprocess.NormalizeMode.MEAN_STD,
        mean=IMAGENET_MEAN, std=IMAGENET_STD, interp=m)
        for m in ("bicubic", "lanczos", "area")}
    c = [
        ("box_blur", lambda d, v: filters.box_blur(d["rgb"], (5, 5),
                                                   device=v)),
        ("spatial_gradient", lambda d, v: filters.spatial_gradient(
            d["gray"], device=v)),
        ("laplacian", lambda d, v: filters.laplacian(d["gray"], device=v)),
        ("filter2d", lambda d, v: filters.filter2d(d["gray"], d["kernel"],
                                                   device=v)),
        ("median_blur 3", lambda d, v: filters.median_blur(d["rgb"], 3,
                                                           device=v)),
        ("median_blur 5", lambda d, v: filters.median_blur(d["gray"], 5,
                                                           device=v)),
        ("bilateral_blur", lambda d, v: filters.bilateral_blur(
            d["rgb"], 5, 30.0, 3.0, device=v)),
        ("gray_to_rgb", lambda d, v: color.gray_to_rgb(d["gray"][..., None],
                                                       device=v)),
        ("rgba_to_rgb", lambda d, v: color.rgba_to_rgb(d["rgba"], device=v)),
        ("bgra_to_rgba", lambda d, v: color.bgra_to_rgba(d["rgba"],
                                                         device=v)),
        ("rgb_to_rgba", lambda d, v: color.rgb_to_rgba(d["rgb"], device=v)),
        ("apply_colormap", lambda d, v: color.apply_colormap(
            d["gray"], "turbo", device=v)),
    ]
    for name, kind in (("rgb_to_gray", "rgb"), ("bgr_to_gray", "rgb"),
                       ("rgb_to_bgr", "rgb"), ("rgb_to_hsv", "rgb"),
                       ("rgb_to_hls", "rgb"), ("rgb_to_xyz", "rgbf"),
                       ("rgb_to_lab", "rgbf"), ("rgb_to_luv", "rgb"),
                       ("rgb_to_yuv", "rgb"), ("sepia", "rgb"),
                       ("hsv_to_rgb", "rgb_to_hsv"),
                       ("hls_to_rgb", "rgb_to_hls"),
                       ("xyz_to_rgb", "rgb_to_xyz"),
                       ("lab_to_rgb", "rgb_to_lab"),
                       ("luv_to_rgb", "rgb_to_luv"),
                       ("yuv_to_rgb", "rgb_to_yuv")):
        c.append((name, lambda d, v, name=name, kind=kind: getattr(
            color, name)(d[kind], device=v)))
    c += [
        ("normalize_mean_std", lambda d, v: normalize.normalize_mean_std(
            d["rgb"], IMAGENET_MEAN, IMAGENET_STD, device=v)),
        ("denormalize_mean_std", lambda d, v: normalize.denormalize_mean_std(
            d["rgbf"], IMAGENET_MEAN, IMAGENET_STD, device=v)),
        ("normalize_min_max", lambda d, v: normalize.normalize_min_max(
            d["gray"], device=v)),
        ("histogram_u8", lambda d, v: histogram.histogram_u8(d["gray"],
                                                             device=v)),
        ("histogram", lambda d, v: histogram.histogram(d["rgbf"], 1000,
                                                       device=v)),
        ("add_weighted", lambda d, v: enhance.add_weighted(
            d["rgb"], 0.3, d["b2"], 0.7, 5.0, device=v)),
        ("adjust_brightness", lambda d, v: enhance.adjust_brightness(
            d["rgb"], 1.3, device=v)),
        ("adjust_contrast", lambda d, v: enhance.adjust_contrast(
            d["rgb"], 1.4, device=v)),
        ("adjust_saturation", lambda d, v: enhance.adjust_saturation(
            d["rgb"], 0.6, device=v)),
        ("adjust_hue", lambda d, v: enhance.adjust_hue(d["rgb"], 30.0,
                                                       device=v)),
        ("adjust_gamma", lambda d, v: enhance.adjust_gamma(d["rgb"], 0.7,
                                                           device=v)),
        ("invert", lambda d, v: enhance.invert(d["rgb"], device=v)),
        ("equalize_hist", lambda d, v: enhance.equalize_hist(d["gray"],
                                                             device=v)),
        ("clahe", lambda d, v: enhance.clahe(d["gray"], 2.0, device=v)),
        ("threshold_binary", lambda d, v: threshold.threshold_binary(
            d["gray"], 127.5, 255.0, device=v)),
        ("threshold_binary_inverse",
         lambda d, v: threshold.threshold_binary_inverse(
             d["gray"], 127.5, 255.0, device=v)),
        ("threshold_truncate", lambda d, v: threshold.threshold_truncate(
            d["gray"], 127.7, device=v)),
        ("threshold_to_zero", lambda d, v: threshold.threshold_to_zero(
            d["gray"], 100.0, device=v)),
        ("threshold_to_zero_inverse",
         lambda d, v: threshold.threshold_to_zero_inverse(
             d["gray"], 100.0, device=v)),
        ("otsu_threshold", lambda d, v: threshold.otsu_threshold(
            d["gray"], device=v)),
        ("adaptive_threshold mean", lambda d, v: threshold.adaptive_threshold(
            d["gray"], 255.0, "mean", device=v)),
        ("adaptive_threshold gaussian",
         lambda d, v: threshold.adaptive_threshold(
             d["gray"], 255.0, "gaussian", device=v)),
        ("dilate", lambda d, v: morphology.dilate(d["rgb"], (3, 3),
                                                  device=v)),
        ("erode", lambda d, v: morphology.erode(d["rgb"], (4, 2), device=v)),
        ("dilate element", lambda d, v: morphology.dilate(
            d["gray"], kernel=d["se"], device=v)),
        ("erode element", lambda d, v: morphology.erode(
            d["gray"], kernel=d["se"], device=v)),
        ("opening", lambda d, v: morphology.opening(d["gray"], (5, 5),
                                                    device=v)),
        ("closing", lambda d, v: morphology.closing(d["gray"], (5, 5),
                                                    device=v)),
        ("gradient", lambda d, v: morphology.gradient(d["gray"], device=v)),
        ("top_hat", lambda d, v: morphology.top_hat(d["gray"], device=v)),
        ("black_hat", lambda d, v: morphology.black_hat(d["gray"],
                                                        device=v)),
        ("canny", lambda d, v: canny.canny(d["gray"], 50.0, 120.0,
                                           device=v)),
        ("mosaic", lambda d, v: bayer.mosaic(d["rgb"], "rggb", device=v)),
        ("demosaic_bilinear", lambda d, v: bayer.demosaic_bilinear(
            d["raw"], "rggb", device=v)),
    ]
    for mode in ("nearest", "bilinear", "bicubic", "lanczos", "area"):
        c.append((f"resize_fast {mode}",
                  lambda d, v, mode=mode: resize.resize_fast(
                      d["rgb"], (hh * 2 // 3, ww * 2 // 3), mode, device=v)))
    c.append(("resize lanczos antialias", lambda d, v: resize.resize(
        d["rgb"].to(v), (hh // 2, ww // 2), "lanczos", True)))
    for m, cfg in pre.items():
        c.append((f"resize_normalize_to_tensor {m}",
                  lambda d, v, cfg=cfg: preprocess.resize_normalize_to_tensor(
                      d["rgb"], cfg, device=v)))
    c += [
        ("rgb_from_nv12", lambda d, v: yuv.rgb_from_nv12(d["y"].to(v),
                                                         d["uv"].to(v))),
        ("rgb_from_nv21", lambda d, v: yuv.rgb_from_nv21(d["y"], d["uv"],
                                                         device=v)),
        ("rgb_from_i420", lambda d, v: yuv.rgb_from_i420(
            d["y"], d["u"], d["v"], device=v)),
        ("rgb_from_yv12", lambda d, v: yuv.rgb_from_yv12(
            d["y"], d["v"], d["u"], device=v)),
        ("rgb_from_yuyv", lambda d, v: yuv.rgb_from_yuyv(d["packed"],
                                                         device=v)),
        ("rgb_from_uyvy", lambda d, v: yuv.rgb_from_uyvy(d["packed"],
                                                         device=v)),
        ("rgb_from_yvyu", lambda d, v: yuv.rgb_from_yvyu(d["packed"],
                                                         device=v)),
        ("nv12_from_rgb", lambda d, v: yuv.nv12_from_rgb(d["rgb"],
                                                         device=v)),
        ("scale_pyramid", lambda d, v: pyramid.scale_pyramid(
            d["gray"], 8, 1.2, device=v)),
        ("harris_response box", lambda d, v: responses.harris_response(
            d["gray"].to(v).float(), block_size=3, window="box")),
        ("shi_tomasi_response", lambda d, v: responses.shi_tomasi_response(
            d["gray"], device=v)),
        ("hessian_response", lambda d, v: responses.hessian_response(
            d["gray"], device=v)),
        ("dog_response", lambda d, v: responses.dog_response(d["gray"],
                                                             device=v)),
        ("distance_transform", lambda d, v:
         distance_transform.distance_transform(d["mask"], device=v)),
    ]
    for name in ("mse", "l1", "huber", "psnr", "ssim"):
        c.append((name, lambda d, v, name=name: getattr(metrics, name)(
            d["rgb"], d["b2"], device=v)))
    c += [
        ("hflip", lambda d, v: geometry_utils.hflip(d["rgb"], device=v)),
        ("vflip", lambda d, v: geometry_utils.vflip(d["rgb"], device=v)),
        ("rot180", lambda d, v: geometry_utils.rot180(d["rgb"], device=v)),
        ("crop", lambda d, v: geometry_utils.crop(
            d["rgb"], ww // 16, hh // 20, ww // 3, hh // 2, device=v)),
        ("center_crop", lambda d, v: geometry_utils.center_crop(
            d["rgb"], (hh * 2 // 3, ww * 2 // 3), device=v)),
        ("dynamic_crop", lambda d, v: geometry_utils.dynamic_crop(
            d["rgb"], d["off"][0], d["off"][1], ww // 3, hh // 2,
            device=v)),
        ("pad", lambda d, v: geometry_utils.pad(d["rgb"], 8, 8, 16, 16,
                                                "reflect", device=v)),
        ("draw_line", lambda d, v: draw.draw_line(
            d["rgb"], (10.5, 20.0), (1800.0, 1000.5), (255, 0, 0), 3.0,
            device=v)),
        ("draw_circle", lambda d, v: draw.draw_circle(
            d["rgb"], (960.0, 540.0), 300.0, (0, 255, 0), 4.0, device=v)),
        ("draw_rect", lambda d, v: draw.draw_rect(
            d["rgb"], (100, 100), (900, 700), (0, 0, 255), 2.0, device=v)),
        ("draw_keypoints", lambda d, v: draw.draw_keypoints(
            d["rgb"], d["xy"], device=v)),
    ]
    return c


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def imgproc_err(name, card, cpu):
    """(largest difference, its measure, whether within IMGPROC_TOL)."""
    card, cpu = _flat(card), _flat(cpu)
    if len(card) != len(cpu):
        raise AssertionError(f"imgproc {name}: {len(card)} outputs on the "
                             f"card, {len(cpu)} on the CPU")
    worst = 0.0
    for a, b in zip(card, cpu):
        if a.shape != b.shape or a.dtype != b.dtype or not a.is_cuda:
            raise AssertionError(f"imgproc {name}: card {a.shape} {a.dtype} "
                                 f"{a.device}, CPU {b.shape} {b.dtype}")
        if a.dtype.is_floating_point and not torch.isfinite(a).all():
            raise AssertionError(f"imgproc {name}: not finite on the card")
        kind, tol = IMGPROC_TOL.get(name, (
            "rel", 1e-5) if a.dtype.is_floating_point else ("lsb", 0))
        diff = (a.cpu().double() - b.double()).abs()
        if kind == "share":
            val = float((diff > 0).double().mean()) if diff.numel() else 0.0
        elif kind == "rel":
            val = float(diff.max()) / max(1.0, float(b.double().abs().max()))
        else:
            val = float(diff.max()) if diff.numel() else 0.0
        if val > tol:
            raise AssertionError(f"imgproc {name}: card and CPU route differ "
                                 f"by {val} ({kind}), above {tol}")
        worst = max(worst, val)
    return worst, kind


def phase_imgproc(card_line):
    """The fast_detector path and the dense chain at 1080p (docstring 16).
    Returns K1's score-only cases for the kernels line and the path's K1
    launches."""
    t_phase = time.perf_counter()
    frame = imgproc_frame()
    hh, ww = HW_1080P
    rgb = torch.as_tensor(frame, device=DEV)
    gray = color.rgb_to_gray(rgb, device=DEV)[..., 0]
    gray_cpu = gray.cpu()
    if not torch.equal(gray_cpu, color.rgb_to_gray(
            torch.as_tensor(frame), device="cpu")[..., 0]):
        raise AssertionError("rgb_to_gray: card and CPU differ")
    roi = torch.zeros((hh, ww), dtype=torch.float32, device=DEV)
    roi[:, : int(ROI_SHARE * ww)] = 1.0                # 1 on the border too
    cases = (("fast_detect", {}), ("fast_detect roi", {"border_mask": roi}),
             ("fast_detect no-nms", {"nms": False}))
    k1_launches = 0
    for label, kw in cases:
        def call(kw=kw):
            return fast.fast_detect(gray, FAST_THRESHOLD, FAST_MAX_KP,
                                    device=DEV, **kw)

        call()                                         # warm-up
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        kps = _no_wait(call)
        torch.cuda.synchronize()
        launches = dict(ck.LAUNCHES)
        only(launches, {"fast_score": 1})
        k1_launches += launches["fast_score"]
        nms = kw.get("nms", True)
        mask = kw.get("border_mask")
        score = ck.fast_score(gray, FAST_THRESHOLD, nms=nms, mask=mask)
        plain = ck._fast_score_plain(gray, FAST_THRESHOLD, nms, mask)
        if not torch.equal(score, plain):
            raise AssertionError(f"{label}: K1 score-only differs from its "
                                 f"plain version by {max_err(score, plain)}")
        want = fast.fast_detect(
            gray_cpu, FAST_THRESHOLD, FAST_MAX_KP, device="cpu",
            **{k: (v.cpu() if isinstance(v, torch.Tensor) else v)
               for k, v in kw.items()})
        for name, a, b in zip(kps._fields, kps, want):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"{label}: keypoint {name} differs from "
                                     "the CPU route")
        xy = kps.xy[kps.mask].cpu()
        n_kp = int(xy.shape[0])
        x_hi = ROI_SHARE * ww if mask is not None else ww - 3
        if n_kp < 100 or not ((xy[:, 0] >= 3) & (xy[:, 0] < x_hi)
                              & (xy[:, 0] < ww - 3) & (xy[:, 1] >= 3)
                              & (xy[:, 1] < hh - 3)).all():
            raise AssertionError(f"{label}: {n_kp} keypoints, some outside "
                                 "the ROI or within 3 px of the border")
        call_ms = cuda_ms(call)
        dev = {}
        dev_ms = device_ms(call, out=dev)
        host = host_us(call, calls=200)
        log(f"imgproc {label}: call {call_ms:.4f} ms (median of {REPS}), "
            f"device {dev_ms:.4f} ms, {dev['launches']} launches a call "
            f"(K1 fast_score 1), host {host:.1f} us per call, {n_kp} "
            f"keypoints, equal to the CPU route, none outside the ROI or "
            f"the 3-px border, no host sync [{card_line}]")

    # K1's score-only forms beside their plain versions and bound
    px = hh * ww
    k1_cases = []
    for label, nms, mask in (("score-only, nms, 1080p", True, None),
                             ("score-only, nms, ROI mask, 1080p", True, roi),
                             ("score-only, no nms, 1080p", False, None)):
        times = kernel_times(
            lambda nms=nms, mask=mask: ck.fast_score(
                gray, FAST_THRESHOLD, nms=nms, mask=mask),
            lambda nms=nms, mask=mask: ck._fast_score_plain(
                gray, FAST_THRESHOLD, nms, mask))
        # per pixel: the 99 integer operations of the arc test and score;
        # f32: threshold, the mask multiply, the 3x3 pool and compare
        nbytes = px * (1 + 4 + (4 if mask is not None else 0))
        f32 = px * (1 + (1 if mask is not None else 0) + (9 if nms else 0))
        bms, by = bound(nbytes, px * 99, f32)
        k1_cases.append({"case": label, "launches": 1, "max_abs_err": 0.0,
                         "bound_ms": bms, "bound_by": by, **times})
        log(f"time fast_score ({label}): {fmt_times(times)}, bound "
            f"{bms:.5f} ms ({by}) [{card_line}]")

    # the dense chain
    t0 = time.perf_counter()
    inputs_cpu = imgproc_inputs(frame)
    inputs_dev = {k: v.to(DEV) for k, v in inputs_cpu.items()}
    cpu_s = time.perf_counter() - t0
    chain = imgproc_chain(hh, ww)
    slow = []
    for name, fn in chain:
        t0 = time.perf_counter()
        want = fn(inputs_cpu, "cpu")
        cpu_s += time.perf_counter() - t0
        fn(inputs_dev, DEV)                              # warm-up
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        got = _no_wait(lambda: fn(inputs_dev, DEV))
        torch.cuda.synchronize()
        if any(ck.LAUNCHES.values()):
            raise AssertionError(f"imgproc {name}: hand kernels launched "
                                 f"{ck.LAUNCHES}")
        err, kind = imgproc_err(name, got, want)
        call_ms = cuda_ms(lambda: fn(inputs_dev, DEV), reps=5, warmup=0)
        dev = {}
        dev_ms = device_ms(lambda: fn(inputs_dev, DEV), reps=3, warmup=0,
                           cuda_only=True, out=dev)
        slow.append((call_ms, name))
        log(f"imgproc {name}: call {call_ms:.4f} ms, device {dev_ms:.4f} "
            f"ms, launches {dev['launches']}, max err {err:.3g} ({kind}; "
            f"no hand kernel, no host sync) [{card_line}]")
    slow.sort(reverse=True)
    log(f"imgproc: {len(chain)} functions at {hh}x{ww}; slowest by call "
        f"ms: " + ", ".join(f"{n} {ms:.3f}" for ms, n in slow[:8])
        + f"; CPU route {cpu_s:.1f} s; phase "
        f"{time.perf_counter() - t_phase:.1f} s [{card_line}]")
    return k1_cases, k1_launches


# --------------------------------------------------------------------------
# the eleventh slice: K1's FAST-n forms, 5-point two-view, ICP,
# augmentations, the depth warp
# --------------------------------------------------------------------------

FAST_ARCS = (9, 10, 11, 12)
ICP_POINTS = 16384
ICP_DEG = 1.0
ICP_SHIFT = np.array([0.05, 0.0, 0.0])    # 5 cm
ICP_ITERS = 30
ICP_CPU_ITERS = 4


def fast_arc_int_ops(n: int) -> int:
    """Integer operations a pixel of K1's FAST-n score (fast_harris.cu's
    arc loop): 16 ring differences; per side one min/max instruction per
    arc per level of arcs (0 levels for n = 1, 1 for 2-3, 2 for 4-9, 3 for
    10-16) and 8 for the best of the 16 arcs; 3 for the score."""
    n = ck.fast_arc(n)
    levels = 0 if n == 1 else 1 if n <= 3 else 2 if n <= 9 else 3
    return 16 + 2 * (16 * levels + 8) + 3


def icp_scan(seed: int = SEED + 20, n: int = ICP_POINTS):
    """A seed-made scan of ``n`` points (a floor and two walls of a room,
    3-4 m across, with 1 cm bumps) and the same points moved by a known
    rigid transform, 1 degree (three Euler angles along a tilted axis)
    and 5 cm: the source is R⁻¹(target − t), so ICP must find (R, t).
    Returns (source, target, R, t) in float32 / float64."""
    rng = np.random.default_rng(seed)
    k = n // 3
    u = rng.uniform(0, 1, (n, 2))
    pts = np.zeros((n, 3))
    pts[:k] = np.c_[4 * u[:k, 0], 3 * u[:k, 1], np.zeros(k)]
    pts[k:2 * k] = np.c_[4 * u[k:2 * k, 0], np.zeros(k), 2.5 * u[k:2 * k, 1]]
    m = n - 2 * k
    pts[2 * k:] = np.c_[np.zeros(m), 3 * u[2 * k:, 0], 2.5 * u[2 * k:, 1]]
    pts += 0.01 * np.sin(7 * pts[:, [1, 2, 0]])
    ax = np.array([0.3, -0.5, 0.8])
    r = _rot_xyz(ICP_DEG * ax / np.linalg.norm(ax))
    src = (pts - ICP_SHIFT) @ r
    return (src.astype(np.float32), pts.astype(np.float32), r, ICP_SHIFT)


def _fast_arc_cases(card_line, gray, gray_cpu, roi):
    """fast_detect at arc lengths 9-12, NMS on and off, one with the ROI
    mask: one K1 score-only launch each, K1 bit-equal to its plain version,
    keypoints equal to the CPU route's; K1 timed for each form."""
    hh, ww = gray.shape
    px = hh * ww
    cases, launches = [], 0
    forms = [(n, nms, None) for n in FAST_ARCS for nms in (True, False)]
    forms.append((10, True, roi))
    for n, nms, mask in forms:
        label = (f"n={n}, {'nms' if nms else 'no nms'}"
                 + (", ROI mask" if mask is not None else "") + ", 1080p")

        def call(n=n, nms=nms, mask=mask):
            return fast.fast_detect(gray, FAST_THRESHOLD, FAST_MAX_KP, nms=nms,
                                    arc_length=n, border_mask=mask,
                                    device=DEV)

        call()                                           # warm-up
        kps, got = counted(call)
        only(got, {"fast_score": 1})
        launches += got["fast_score"]
        score = ck.fast_score(gray, FAST_THRESHOLD, nms, mask, arc_length=n)
        plain = ck._fast_score_plain(gray, FAST_THRESHOLD, nms, mask, n)
        if not torch.equal(score, plain):
            raise AssertionError(f"fast_detect {label}: K1 differs from its "
                                 f"plain version by {max_err(score, plain)}")
        want = fast.fast_detect(gray_cpu, FAST_THRESHOLD, FAST_MAX_KP,
                                nms=nms, arc_length=n,
                                border_mask=None if mask is None
                                else mask.cpu(), device="cpu")
        for name, a, b in zip(kps._fields, kps, want):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"fast_detect {label}: keypoint {name} "
                                     "differs from the CPU route")
        # FAST-12 finds few corners on the frame's 6-px blocks
        n_kp = int(kps.mask.sum())
        if n_kp < 1:
            raise AssertionError(f"fast_detect {label}: no keypoint")
        times = kernel_times(
            lambda n=n, nms=nms, mask=mask: ck.fast_score(
                gray, FAST_THRESHOLD, nms, mask, arc_length=n),
            lambda n=n, nms=nms, mask=mask: ck._fast_score_plain(
                gray, FAST_THRESHOLD, nms, mask, n))
        nbytes = px * (1 + 4 + (4 if mask is not None else 0))
        f32 = px * (1 + (1 if mask is not None else 0) + (9 if nms else 0))
        int_ops = px * fast_arc_int_ops(n)
        bms, by = bound(nbytes, int_ops, f32)
        cases.append({"case": f"score-only, {label}", "launches": 1,
                      "max_abs_err": 0.0, "arc_length": n,
                      "int_ops_per_pixel": fast_arc_int_ops(n),
                      "bound_ms": bms, "bound_by": by, **times})
        log(f"fast_detect {label}: 1 K1 launch (fast_score), {n_kp} "
            f"keypoints equal to the CPU route, K1 bit-equal to its plain "
            f"version; time fast_score: {fmt_times(times)}, bound {bms:.5f} "
            f"ms ({by}: {fast_arc_int_ops(n)} int32 ops a pixel) "
            f"[{card_line}]")
    return cases, launches


def _five_point_pair(card_line):
    """ORB (OrbConfig()) on the two-plane pair, match, and the 5-point
    two-view; gated on the truth."""
    img1, img2, r_gt, t_gt = render_scene()
    cfg = orb.OrbConfig()
    params = twoview.TwoViewParams(solver="5pt")

    def pose(x1, x2, mk):
        return twoview.estimate_relative_pose(
            x1, x2, K_EUROC, K_EUROC, mask=mk, params=params,
            generator=torch.Generator(device=DEV).manual_seed(SEED),
            device=DEV)

    def pair():
        f1 = orb.orb_detect_and_describe(img1, cfg, device=DEV)
        f2 = orb.orb_detect_and_describe(img2, cfg, device=DEV)
        m = matching.match_descriptors(f1.descriptors, f2.descriptors,
                                       a_mask=f1.mask, b_mask=f2.mask,
                                       max_distance=64, ratio=0.8,
                                       device=DEV)
        x1, x2, mk = matching.matched_points(f1.xy, f2.xy, m)
        return x1, x2, mk, pose(x1, x2, mk)

    pair()                                               # warm-up
    (x1, x2, mk, res), launches = counted(pair)
    only(launches, {"fast_harris": 2, "windows_paired": 4,
                    "brief_rotated": 2})
    r_est = res.rotation.double().cpu().numpy()
    t_est = res.translation.double().cpu().numpy()
    if not (np.isfinite(r_est).all() and np.isfinite(t_est).all()):
        raise AssertionError("5-point pose not finite")
    rerr, terr = rot_err_deg(r_est, r_gt), dir_err_deg(t_est, t_gt)
    n_inl = int(res.n_inliers)
    if not (rerr < 0.5 and terr < 3.0):
        raise AssertionError(f"5-point pose: rotation {rerr} deg, direction "
                             f"{terr} deg (bounds 0.5, 3)")
    call_ms = cuda_ms(lambda: pose(x1, x2, mk), reps=3, warmup=1)
    prof = device_share("5-point estimate_relative_pose",
                        lambda: pose(x1, x2, mk), card_line,
                        cuda_only=True) or {}
    log(f"twoview 5pt: matches {int(mk.sum())}, inliers {n_inl}, homography "
        f"{bool(res.use_homography)}, rotation error {rerr:.4f} deg, "
        f"direction error {terr:.4f} deg; estimate_relative_pose call "
        f"{call_ms:.3f} ms (median of 3), {prof.get('launches')} launches, "
        f"device busy {prof.get('busy_share')}; the pair's hand kernels "
        f"{ {k: v for k, v in launches.items() if v} } [{card_line}]")
    return {"rotation_deg": rerr, "direction_deg": terr, "inliers": n_inl,
            "call_ms": call_ms, "launches": prof.get("launches")}


def _icp_case(card_line):
    """ICP at 16,384² on the card, gated on the truth and held to the CPU
    route."""
    src, dst, r_gt, t_gt = icp_scan()
    params = icp.ICPParams(max_iterations=ICP_ITERS)
    s_dev = torch.as_tensor(src, device=DEV)
    d_dev = torch.as_tensor(dst, device=DEV)

    def run():
        return icp.icp_vanilla(s_dev, d_dev, params, device=DEV)

    run()                                                # warm-up
    torch.cuda.reset_peak_memory_stats()
    res, launches = counted(lambda: _no_wait(run))
    only(launches, {})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    r = res.rotation.double().cpu().numpy()
    t = res.translation.double().cpu().numpy()
    rerr = np.degrees(chord_rad(r, r_gt))
    terr = float(np.linalg.norm(t - t_gt))
    if not (rerr < 0.01 and terr < 1e-3 and float(res.rmse) < 1e-3):
        raise AssertionError(f"ICP: rotation {rerr} deg, translation {terr}, "
                             f"rmse {float(res.rmse)} off the truth")
    # card against the CPU route over the first ICP_CPU_ITERS iterations:
    # each CPU iteration writes and reads four 1.07 GB matrices (~2 s on
    # 8 CPU cores), so all 30 would take a minute
    short = icp.ICPParams(max_iterations=ICP_CPU_ITERS)
    r_short = icp.icp_vanilla(s_dev, d_dev, short, device=DEV).rotation
    t0 = time.perf_counter()
    cpu = icp.icp_vanilla(torch.as_tensor(src), torch.as_tensor(dst), short,
                          device="cpu")
    cpu_s = time.perf_counter() - t0
    dr = float((r_short.cpu() - cpu.rotation).abs().max())
    if dr > 1e-4:
        raise AssertionError(f"ICP: card and CPU rotations differ by {dr}")
    call_ms = cuda_ms(run, reps=3, warmup=0)
    dev_ms = device_ms(run, reps=2, warmup=0, cuda_only=True)
    log(f"icp {ICP_POINTS} x {ICP_POINTS}, {ICP_ITERS} iterations: rotation "
        f"error {rerr:.5f} deg, translation error {terr:.2e}, rmse "
        f"{float(res.rmse):.3e}; after {ICP_CPU_ITERS} iterations card vs "
        f"CPU route rotation {dr:.2e} (CPU {cpu_s:.1f} s); call {call_ms:.3f} ms (median of 3), device "
        f"{dev_ms:.3f} ms, peak device memory {peak:.2f} GiB, no hand "
        f"kernel, no host sync [{card_line}]")
    return {"call_ms": call_ms, "device_ms": dev_ms, "rotation_deg": rerr,
            "card_vs_cpu": dr, "peak_gib": peak}


def _aug_case(card_line, frame):
    """The augmentation pipeline at 1080p (flip, jitter, blur, affine,
    erasing) and apply_batch over 4: K7 once per image, held to the CPU
    route on the same draws."""
    augs = [augmentations.RandomHorizontalFlip(), augmentations.ColorJitter(),
            augmentations.RandomGaussianBlur(p=1.0),
            augmentations.RandomAffine(), augmentations.RandomErasing(p=1.0)]
    pipe = augmentations.AugmentationPipeline(augs, seed=SEED, device=DEV)
    cpu_pipe = augmentations.AugmentationPipeline(augs, seed=SEED,
                                                  device="cpu")
    img = torch.as_tensor(frame, device=DEV)
    batch = torch.stack([img, img.flip(0), img.flip(1), img.roll(97, 1)])
    pipe(img)                                            # warm-up
    out = {}
    for label, fn, n_img in (
            ("pipeline", lambda: pipe(img), 1),
            ("apply_batch", lambda: pipe.apply_batch(batch), 4)):
        pipe.set_seed(SEED + 1)
        got, launches = counted(lambda: _no_wait(fn))
        only(launches, {"remap": n_img})
        # the same draws again, taken from the generator in the call's order
        pipe.set_seed(SEED + 1)
        imgs = img[None] if n_img == 1 else batch
        draws = [[a.draw(pipe._gen, imgs[i]) for a in augs]
                 for i in range(n_img)]
        again = (pipe(img, draws=draws[0]) if n_img == 1
                 else pipe.apply_batch(batch, draws=draws))
        if not torch.equal(again, got):
            raise AssertionError(f"augmentation {label}: the replayed draws "
                                 "give another image")
        cpu_draws = [[{k: v.cpu() for k, v in d.items()} for d in per]
                     for per in draws]
        want = (cpu_pipe(img.cpu(), draws=cpu_draws[0]) if n_img == 1
                else cpu_pipe.apply_batch(batch.cpu(), draws=cpu_draws))
        err, kind = imgproc_err(f"augmentation {label}", got, want)
        share = float(((got.cpu().int() - want.int()).abs() > 0)
                      .double().mean())
        call_ms = cuda_ms(fn, reps=5, warmup=1)
        dev = {}
        dev_ms = device_ms(fn, reps=3, warmup=0, cuda_only=True, out=dev)
        out[label] = {"call_ms": call_ms, "device_ms": dev_ms,
                      "remap_launches": launches["remap"],
                      "launches": dev["launches"]}
        log(f"augmentation {label} ({n_img} x 1080x1920x3 u8; flip, jitter, "
            f"blur, affine, erasing): K7 remap {launches['remap']} (1 an "
            f"image), no host sync; card vs CPU route on the same draws "
            f"{err:.3g} ({kind}) on {share:.2e} of the values; call "
            f"{call_ms:.3f} ms, device {dev_ms:.3f} ms, {dev['launches']} "
            f"launches [{card_line}]")
    return out


def _depth_case(card_line):
    """warp_frame_depth at 480×752: one K7 launch, held to the CPU
    route."""
    img = render_scene()[0]
    yy, xx = np.mgrid[0:H, 0:W]
    rng = np.random.default_rng(SEED + 21)
    d = (3.0 + 0.8 * np.sin(xx / 60.0) + 0.5 * yy / H
         + rng.normal(0, 0.005, (H, W))).astype(np.float32)
    t44 = np.eye(4, dtype=np.float32)
    t44[:3, :3] = _rot_xyz((0.5, -1.0, 0.3))
    t44[:3, 3] = (0.05, -0.02, 0.01)
    args = [torch.as_tensor(a, device=DEV) for a in (img, d, t44, K_EUROC)]

    def run():
        return depth.warp_frame_depth(*args, device=DEV)

    run()                                                # warm-up
    got, launches = counted(lambda: _no_wait(run))
    only(launches, {"remap": 1})
    want = depth.warp_frame_depth(img, d, t44, K_EUROC, device="cpu")
    err, kind = imgproc_err("warp_frame_depth", got, want)
    share = float(((got.cpu().int() - want.int()).abs() > 0).double().mean())
    call_ms = cuda_ms(run)
    dev = {}
    dev_ms = device_ms(run, out=dev)
    log(f"warp_frame_depth {H}x{W} u8: K7 remap 1, no host sync; card vs CPU "
        f"route {err:.3g} ({kind}) on {share:.2e} of the pixels; call "
        f"{call_ms:.4f} ms, device {dev_ms:.4f} ms, {dev['launches']} "
        f"launches [{card_line}]")
    return {"call_ms": call_ms, "device_ms": dev_ms}


def phase_geometry15b(card_line):
    """The eleventh slice (docstring 17). Returns K1's FAST-n cases and
    their launches, and K7's launches on the new paths."""
    t_phase = time.perf_counter()
    frame = imgproc_frame()
    hh, ww = HW_1080P
    rgb = torch.as_tensor(frame, device=DEV)
    gray = color.rgb_to_gray(rgb, device=DEV)[..., 0]
    roi = torch.zeros((hh, ww), dtype=torch.float32, device=DEV)
    roi[:, : int(ROI_SHARE * ww)] = 1.0
    k1_cases, k1_launches = _fast_arc_cases(card_line, gray, gray.cpu(), roi)
    summary = {"twoview_5pt": _five_point_pair(card_line),
               "icp": _icp_case(card_line)}
    augs = _aug_case(card_line, frame)
    summary["augmentations"] = augs
    summary["warp_frame_depth"] = _depth_case(card_line)
    k7_paths = {"augmentation pipeline": augs["pipeline"]["remap_launches"],
                "augmentation apply_batch":
                    augs["apply_batch"]["remap_launches"],
                "warp_frame_depth": 1}
    log(f"geometry15b: {json.dumps(summary)}")
    log(f"geometry15b phase: {time.perf_counter() - t_phase:.1f} s "
        f"[{card_line}]")
    return k1_cases, k1_launches, k7_paths


# --------------------------------------------------------------------------
# the twelfth slice: AprilTag detect → pose, the dense CCL, host formats
# --------------------------------------------------------------------------

TAG_K = np.array([[1400.0, 0.0, 960.0], [0.0, 1400.0, 540.0],
                  [0.0, 0.0, 1.0]])     # 1080p intrinsics
TAG_SIZE = 0.16                         # m, the black border's edge
TAG_IDS = tuple(range(0, 16 * 37, 37))  # 16 distinct tag36h11 ids
TAG_PX_PER_CELL = 24                    # the rendered tag's resolution
TAG_SIGMA = 4.0                         # pixel noise of the scene
TAG_CELL = (270, 480)                   # the 4 × 4 layout's cells at 1080p


def _tag_plane_h(rot, t):
    """The homography from the tag plane (metres, z = 0) to pixels."""
    return TAG_K @ np.stack([rot[:, 0], rot[:, 1], t], 1)


def tag_poses(seed: int = SEED + 30):
    """16 tag poses on a 4 × 4 layout: depth 1.2–3.0 m (shuffled), each
    tilted 30–40° about an axis in its plane and turned up to ±15° in it,
    drawn again until the tag with its quiet zone stays 12 px inside its
    cell. Returns a list of (rotation, translation). Below 30° of tilt a
    tag of 60–100 px is close to the fronto-parallel ambiguity: in a
    20–40° draw over 12 scenes, a far tag's rotation error reached 20°
    (CPU route; the card's detections are the same)."""
    rng = np.random.default_rng(seed)
    depths = rng.permutation(np.linspace(1.2, 3.0, 16))
    kinv = np.linalg.inv(TAG_K)
    quiet = 0.5 * TAG_SIZE * 10 / 8          # the quiet zone's half edge
    box = np.array([[-quiet, -quiet, 1.0], [quiet, -quiet, 1.0],
                    [quiet, quiet, 1.0], [-quiet, quiet, 1.0]])
    ch, cw = TAG_CELL
    poses = []
    for i in range(16):
        r, c = divmod(i, 4)
        centre = np.array([cw * (c + 0.5), ch * (r + 0.5), 1.0])
        t = depths[i] * (kinv @ centre)
        while True:
            phi = rng.uniform(0, 2 * np.pi)
            tilt = np.radians(rng.uniform(30, 40))
            roll = np.radians(rng.uniform(-15, 15))
            axis = np.array([np.cos(phi), np.sin(phi), 0.0])
            kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                           [-axis[1], axis[0], 0]])
            r_tilt = (np.eye(3) + np.sin(tilt) * kx
                      + (1 - np.cos(tilt)) * kx @ kx)
            r_roll = np.array([[np.cos(roll), -np.sin(roll), 0],
                               [np.sin(roll), np.cos(roll), 0], [0, 0, 1]])
            rot = r_tilt @ r_roll
            p = box @ _tag_plane_h(rot, t).T
            p = p[:, :2] / p[:, 2:]
            if (p[:, 0].min() >= cw * c + 12 and p[:, 0].max() <= cw * (c + 1) - 12
                    and p[:, 1].min() >= ch * r + 12
                    and p[:, 1].max() <= ch * (r + 1) - 12):
                break
        poses.append((rot, t))
    return poses


def tag_corners(rot, t) -> np.ndarray:
    """The black border's corners in pixels (pixel centres at integers),
    in the detector's order: corner 0 is the tag's (−1, −1)."""
    h = TAG_SIZE / 2
    obj = np.array([[-h, -h, 1.0], [h, -h, 1.0], [h, h, 1.0], [-h, h, 1.0]])
    p = obj @ _tag_plane_h(rot, t).T
    return p[:, :2] / p[:, 2:]


def tag_scene(seed: int = SEED + 30):
    """A 1080×1920 u8 gray frame with the 16 tags of :func:`tag_poses`
    (tag36h11, ``TAG_IDS``) on the textured gray of
    :func:`imgproc_frame`, σ 4 noise. Each tag is rendered by
    ``render_tag`` (24 px a cell) and warped in with numpy: 2 × 2 samples
    a pixel, each bilinear in the tag image, blended by the share that
    falls on the tag. Returns (gray, [(id, rotation, translation,
    corners)])."""
    fam = apriltag.get_family("tag36h11")
    frame = imgproc_frame()
    gray = color.rgb_to_gray(frame, device="cpu")[..., 0].numpy().astype(
        np.float64)
    s = TAG_PX_PER_CELL
    n_px = fam.total_width * s
    # tag image edge coordinates → tag plane metres
    a = TAG_SIZE / (fam.width_at_border * s)
    to_plane = np.array([[a, 0, -a * n_px / 2], [0, a, -a * n_px / 2],
                         [0, 0, 1.0]])
    sub = np.array([[-0.25, -0.25], [0.25, -0.25], [-0.25, 0.25],
                    [0.25, 0.25]])
    truth = []
    for tag_id, (rot, t) in zip(TAG_IDS, tag_poses(seed)):
        tag = apriltag.render_tag(fam, tag_id, scale=s).astype(np.float64)
        h_img = _tag_plane_h(rot, t) @ to_plane
        inv = np.linalg.inv(h_img)
        edge = np.array([[0, 0, 1.0], [n_px, 0, 1], [n_px, n_px, 1],
                         [0, n_px, 1]]) @ h_img.T
        edge = edge[:, :2] / edge[:, 2:]
        x0, y0 = np.floor(edge.min(0)).astype(int) - 1
        x1, y1 = np.ceil(edge.max(0)).astype(int) + 1
        ys, xs = np.mgrid[y0:y1 + 1, x0:x1 + 1]
        acc = np.zeros(ys.shape)
        cover = np.zeros(ys.shape)
        for dx, dy in sub:
            q = np.stack([xs + dx, ys + dy, np.ones(ys.shape)], -1) @ inv.T
            u, v = q[..., 0] / q[..., 2], q[..., 1] / q[..., 2]
            inside = (u >= 0) & (u < n_px) & (v >= 0) & (v < n_px)
            # bilinear in the tag image, its pixel centres at k + 0.5
            uu = np.clip(u - 0.5, 0, n_px - 1.001)
            vv = np.clip(v - 0.5, 0, n_px - 1.001)
            iu, iv = uu.astype(int), vv.astype(int)
            fu, fv = uu - iu, vv - iv
            val = (tag[iv, iu] * (1 - fu) * (1 - fv)
                   + tag[iv, iu + 1] * fu * (1 - fv)
                   + tag[iv + 1, iu] * (1 - fu) * fv
                   + tag[iv + 1, iu + 1] * fu * fv)
            acc += np.where(inside, val, 0.0)
            cover += inside
        patch = gray[y0:y1 + 1, x0:x1 + 1]
        share = cover / len(sub)
        gray[y0:y1 + 1, x0:x1 + 1] = (
            patch * (1 - share) + np.where(cover > 0, acc / np.maximum(
                cover, 1), 0.0) * share)
        truth.append((tag_id, rot, t, tag_corners(rot, t)))
    rng = np.random.default_rng(seed + 1)
    gray = np.clip(np.round(gray + rng.normal(0, TAG_SIGMA, gray.shape)),
                   0, 255).astype(np.uint8)
    return gray, truth


def tag_errors(dets, truth) -> dict:
    """Per tag: corner error (px) against the projected truth, and
    ``estimate_tag_pose``'s rotation error (°) and translation error (m,
    and its share of the depth). Raises unless every tag is found once
    with hamming 0 and nothing else is."""
    by_id = {d.tag_id: d for d in dets}
    ids = sorted(d.tag_id for d in dets)
    if ids != sorted(TAG_IDS) or any(d.hamming for d in dets):
        raise AssertionError(f"apriltag: found {[(d.tag_id, d.hamming) for d in dets]}, want {TAG_IDS} at hamming 0")
    rows = []
    for tag_id, rot, t, corners in truth:
        d = by_id[tag_id]
        pair = apriltag.estimate_tag_pose(d, TAG_K, TAG_SIZE)
        rows.append({
            "id": tag_id, "depth_m": float(t[2]),
            "corner_px": float(np.linalg.norm(d.corners - corners,
                                              axis=1).max()),
            "rot_deg": rot_err_deg(pair.best.rotation, rot),
            "trans_m": float(np.linalg.norm(pair.best.translation - t)),
            "ambiguity": float(pair.ambiguity)})
        rows[-1]["trans_share"] = rows[-1]["trans_m"] / float(t[2])
    return rows


# Pose and corner gates. Every tag: translation within 2% of its depth,
# corners within 1.5 px. Tags up to 1.8 m (≥ 85 px; the reference's pose
# test has a 96 px tag at 1 m): corners 1 px, rotation 2°. Over the 16 tags:
# median corner 0.5 px, median rotation 1°. The detector classifies whole
# pixels and fits lines to boundary points on a 0.5 px grid without edge
# refinement, so on a tag of 60–90 px at 2.4–3 m an edge near an axis
# keeps up to 0.5 px of bias: over 16 scenes (seeds 30–45, CPU route) the
# far tags' corners reached 1.02 px and their rotation 20.7°, the near
# tags' rotation 0.48°, while estimate_tag_pose from the true corners is
# within 2e-6°.
TAG_GATES = {"trans_share": 0.02, "corner_px": 1.5, "near_m": 1.8,
             "near_corner_px": 1.0, "near_rot_deg": 2.0,
             "median_corner_px": 0.5, "median_rot_deg": 1.0}


def tag_gate_failures(rows) -> list:
    g = TAG_GATES
    bad = [f"tag {r['id']}: {k} {r[k]:.4f}" for r in rows
           for k, lim in (("trans_share", g["trans_share"]),
                          ("corner_px", g["corner_px"])) if r[k] > lim]
    bad += [f"tag {r['id']} at {r['depth_m']:.2f} m: {k} {r[k]:.4f}"
            for r in rows if r["depth_m"] <= g["near_m"]
            for k, lim in (("corner_px", g["near_corner_px"]),
                           ("rot_deg", g["near_rot_deg"])) if r[k] > lim]
    for k in ("corner_px", "rot_deg"):
        med = float(np.median([r[k] for r in rows]))
        if med > g["median_" + k]:
            bad.append(f"median {k} {med:.4f}")
    return bad


CCL_SWEEPS = 64
FORMAT_POINTS = 100_000


@contextlib.contextmanager
def _environ(**values):
    """Set environment variables while the block runs."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _dets_diff(a, b) -> float:
    """The largest corner or homography difference of two detection lists
    with the same ids and hamming (raises otherwise)."""
    if [(d.tag_id, d.hamming) for d in a] != [(d.tag_id, d.hamming)
                                             for d in b]:
        raise AssertionError(
            f"apriltag: detections differ: {[(d.tag_id, d.hamming) for d in a]}"
            f" against {[(d.tag_id, d.hamming) for d in b]}")
    return max([float(np.abs(x.corners - y.corners).max()) for x, y in
                zip(a, b)] + [float(np.abs(x.homography - y.homography).max())
                              for x, y in zip(a, b)] + [0.0])


def _wall_ms(fn, reps: int = REPS, warmup: int = 2):
    """p50 and p95 of ``fn``'s wall ms (a call that ends on the host)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return _pct(times, 50), _pct(times, 95)


def _tag_detection(card_line, gray, truth, dec):
    """The counted decode on the card, its gates and the pose of each tag."""
    dec.decode(gray)                                   # warm-up
    dets, launches = counted(lambda: dec.decode(gray))
    only(launches, {})
    rows = tag_errors(dets, truth)
    for r in rows:
        log(f"apriltag tag {r['id']:3d}: depth {r['depth_m']:.2f} m, corner "
            f"error {r['corner_px']:.4f} px, rotation {r['rot_deg']:.4f} deg,"
            f" translation {r['trans_m'] * 100:.3f} cm = "
            f"{r['trans_share'] * 100:.3f}% of depth, ambiguity "
            f"{r['ambiguity']:.4f}")
    corner = [r["corner_px"] for r in rows]
    log(f"apriltag detection: {len(dets)}/16 tags, hamming "
        f"{sorted({d.hamming for d in dets})}; corner error median "
        f"{np.median(corner):.4f} max {max(corner):.4f} px; rotation median "
        f"{np.median([r['rot_deg'] for r in rows]):.4f} max "
        f"{max(r['rot_deg'] for r in rows):.4f} deg; translation max "
        f"{max(r['trans_share'] for r in rows) * 100:.3f}% of depth; no hand "
        f"kernel launched")
    bad = tag_gate_failures(rows)
    if bad:
        raise AssertionError(f"apriltag gates ({TAG_GATES}): {bad}")
    return dets, rows


def _tag_parity(gray, g_dev, dets):
    """Card against CPU (threshold bit-equal, detections equal), a device
    tensor input against the numpy one, the numpy mid-pipeline against
    the native one."""
    cfg = apriltag.DetectorConfig()
    args = (cfg.tile_size, cfg.min_white_black_diff, cfg.threshold_split)
    thr_card = apriltag.adaptive_threshold(g_dev, *args, device=DEV)
    thr_cpu = apriltag.adaptive_threshold(gray, *args, device="cpu")
    if not torch.equal(thr_card.cpu(), thr_cpu):
        raise AssertionError("apriltag: threshold differs from the CPU route")
    t0 = time.perf_counter()
    cpu = apriltag.AprilTagDecoder(device="cpu").decode(gray)
    cpu_s = time.perf_counter() - t0
    out = {"threshold_equal": True, "cpu_decode_s": cpu_s,
           "cpu_diff": _dets_diff(dets, cpu),
           "tensor_diff": _dets_diff(
               dets, apriltag.AprilTagDecoder(device=DEV).decode(g_dev))}
    with _environ(KORNIA_TPU_APRILTAG_MID="numpy"):
        t0 = time.perf_counter()
        num = apriltag.AprilTagDecoder(device=DEV).decode(gray)
        out["numpy_route_s"] = time.perf_counter() - t0
    out["numpy_route_diff"] = _dets_diff(dets, num)
    if out["cpu_diff"] or out["tensor_diff"] or \
            out["numpy_route_diff"] > 1e-3:
        raise AssertionError(f"apriltag parity: {out}")
    log(f"apriltag parity: threshold (1080×1920) bit-equal to the CPU "
        f"route; detections equal to the CPU route's ({cpu_s:.2f} s there) "
        f"and to a device-tensor input's; the numpy mid-pipeline's within "
        f"{out['numpy_route_diff']:.3e} px (native quads are float32)")
    return thr_card, out


def _tag_times(card_line, gray, g_dev, dec):
    """Stage, call, threshold and trace times of the decode."""
    with _environ(KORNIA_TPU_APRILTAG_TRACE="1"), \
            contextlib.redirect_stderr(stdio.StringIO()):
        traces = []
        for i in range(REPS + 2):
            dec.decode(gray)
            if i >= 2:
                traces.append(dict(dec.last_trace))
    stages = {k: statistics.median(t[k] for t in traces) for k in traces[0]}
    log("apriltag stages (median of 20, ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()) + f" [{card_line}]")
    dec2 = apriltag.AprilTagDecoder(apriltag.DetectorConfig(quad_decimate=2),
                                    device=DEV)
    call = _wall_ms(lambda: dec.decode(gray))
    call2 = _wall_ms(lambda: dec2.decode(gray))
    n2 = len(dec2.decode(gray))
    log(f"apriltag decode call: p50 {call[0]:.3f} / p95 {call[1]:.3f} ms; "
        f"quad_decimate=2 p50 {call2[0]:.3f} / p95 {call2[1]:.3f} ms ({n2} "
        f"tags found) [{card_line}]")
    cfg = apriltag.DetectorConfig()
    args = (cfg.tile_size, cfg.min_white_black_diff, cfg.threshold_split)
    stats = {}

    def thr():
        return apriltag.adaptive_threshold(g_dev, *args, device=DEV)

    thr_dev = device_ms(thr, out=stats)
    thr_call = cuda_ms(thr)
    hh, ww = gray.shape
    bms, by = bound(2 * hh * ww)
    log(f"apriltag threshold: device {thr_dev:.4f} ms, call {thr_call:.4f} "
        f"ms, {stats['launches']} launches, bound {bms:.5f} ms ({by}: "
        f"{hh * ww} B in, {hh * ww} B out) [{card_line}]")
    _, tr = _frame_trace(lambda: dec.decode(gray))
    _, tr_t = _frame_trace(lambda: dec.decode(g_dev))
    for label, t in (("numpy input", tr), ("device-tensor input", tr_t)):
        # the trace's own closing synchronise is not the decode's
        t["decode_syncs"] = sum("kornia_tpu_torch" in site
                                for site in t["sync_sites"])
        log(f"apriltag decode trace ({label}): wall {t['wall_ms']:.3f} ms, "
            f"{t['launches']} launches, {t['copies']} copies, "
            f"{t['decode_syncs']} host syncs in the decode, "
            f"{t['syncs']} in the trace ({', '.join(t['sync_sites'])}), "
            f"device busy {t['busy_ms']:.4f} ms = "
            f"{t['busy_ms'] / t['wall_ms']:.5f} of wall [{card_line}]")
    return {"stages_ms": stages, "call_ms": call,
            "decimate2_call_ms": call2, "decimate2_found": n2,
            "threshold": {"device_ms": thr_dev, "call_ms": thr_call,
                          "launches": stats["launches"], "bound_ms": bms,
                          "bound_by": by},
            "trace": {k: {n: v for n, v in t.items() if n != "sync_sites"}
                      for k, t in (("numpy", tr), ("tensor", tr_t))}}


def _dense_ccl(card_line, thr_card):
    """connected_components on the frame's black class at 1080p."""
    mask = thr_card == 0
    mask_cpu = mask.cpu()
    out = {}
    for conn in (4, 8):
        (lab, sweeps), launches = counted(
            lambda: ccl._labels_sweeps(mask, conn, CCL_SWEEPS))
        only(launches, {})
        t0 = time.perf_counter()
        lab_cpu, sweeps_cpu = ccl._labels_sweeps(mask_cpu, conn, CCL_SWEEPS)
        cpu_s = time.perf_counter() - t0
        if sweeps_cpu != sweeps or not torch.equal(lab.cpu(), lab_cpu):
            raise AssertionError(f"dense CCL ({conn}) differs from the CPU "
                                 f"route")
        capped = sweeps == CCL_SWEEPS + 1
        if not capped and not np.array_equal(
                ccl.relabel_sequential(lab),
                ccl.connected_components_host(mask_cpu.numpy(), conn)):
            raise AssertionError(f"dense CCL ({conn}): not the host "
                                 f"union-find's partition")

        def run():
            return ccl.connected_components(mask, conn, CCL_SWEEPS,
                                            device=DEV)

        call = cuda_ms(run, reps=5, warmup=1)
        _, tr = _frame_trace(run)
        out[conn] = {"sweeps": sweeps, "capped": capped, "call_ms": call,
                     "device_ms": tr["busy_ms"], "launches": tr["launches"],
                     "syncs": tr["syncs"], "cpu_s": cpu_s}
        log(f"dense CCL connectivity {conn} at 1080p (black class, "
            f"{int(mask_cpu.sum())} px): {sweeps} sweeps"
            + (" (the cap)" if capped else ", converged")
            + f"; call {call:.3f} ms, device {tr['busy_ms']:.3f} ms, "
            f"{tr['launches']} launches ({tr['launches'] / sweeps:.1f} a "
            f"sweep), {tr['syncs']} host syncs; labels equal to the CPU "
            f"route ({cpu_s:.2f} s there)"
            + ("" if capped else " and its partition to "
               "connected_components_host's") + f" [{card_line}]")
    return out


def _host_formats(card_line):
    """find_contours, RVL, PLY and PCD once each, round trips held equal."""
    rng = np.random.default_rng(SEED + 31)
    cells = rng.random((480 // 16 + 1, 752 // 16 + 1)) < 0.3
    mask = np.kron(cells, np.ones((16, 16), np.uint8))[:480, :752]
    mask[rng.random(mask.shape) < 0.002] = 1          # single pixels
    out = {}
    t0 = time.perf_counter()
    cs = contours.find_contours(mask)
    out["find_contours_ms"] = (time.perf_counter() - t0) * 1e3
    n_comp = int(ccl.connected_components_host(mask, 8).max())
    if len(cs) != n_comp or any(len(c) == 0 for c in cs):
        raise AssertionError("find_contours: one contour a component")
    depth = np.kron(rng.integers(500, 5000, (480 // 8, 752 // 8)),
                    np.ones((8, 8))).astype(np.uint16)
    depth[rng.random(depth.shape) < 0.3] = 0
    t0 = time.perf_counter()
    blob = kio.rvl_compress(depth)
    t1 = time.perf_counter()
    back = kio.rvl_decompress(blob)
    t2 = time.perf_counter()
    if not np.array_equal(back, depth):
        raise AssertionError("RVL round trip")
    out.update(rvl_compress_ms=(t1 - t0) * 1e3,
               rvl_decompress_ms=(t2 - t1) * 1e3,
               rvl_ratio=depth.nbytes / len(blob))
    pts = rng.standard_normal((FORMAT_POINTS, 3))
    cols = rng.integers(0, 256, (FORMAT_POINTS, 3), np.uint8)
    nrm = rng.standard_normal((FORMAT_POINTS, 3))
    with tempfile.TemporaryDirectory() as tmp:
        p = os.path.join(tmp, "cloud.ply")
        t0 = time.perf_counter()
        kio.write_ply(p, pts, colors=cols, normals=nrm)
        t1 = time.perf_counter()
        ply = kio.read_ply(p)
        t2 = time.perf_counter()
        if not (np.array_equal(ply["points"], pts)
                and np.array_equal(ply["colors"], cols)
                and np.array_equal(ply["normals"], nrm)):
            raise AssertionError("PLY round trip")
        out.update(ply_write_ms=(t1 - t0) * 1e3, ply_read_ms=(t2 - t1) * 1e3)
        p = os.path.join(tmp, "cloud.pcd")
        pts32 = pts.astype(np.float32)
        t0 = time.perf_counter()
        kio.write_pcd(p, pts32, colors=cols)
        t1 = time.perf_counter()
        pcd = kio.read_pcd(p)
        t2 = time.perf_counter()
        if not (np.array_equal(pcd["points"], pts32)
                and np.array_equal(pcd["colors"], cols)):
            raise AssertionError("PCD round trip")
        out.update(pcd_write_ms=(t1 - t0) * 1e3, pcd_read_ms=(t2 - t1) * 1e3)
    log(f"host formats: find_contours 480×752 ({len(cs)} components) "
        f"{out['find_contours_ms']:.2f} ms; RVL 480×752 u16 compress "
        f"{out['rvl_compress_ms']:.3f} ms, decompress "
        f"{out['rvl_decompress_ms']:.3f} ms, ratio {out['rvl_ratio']:.2f}; "
        f"PLY {FORMAT_POINTS} points write {out['ply_write_ms']:.2f} / read "
        f"{out['ply_read_ms']:.2f} ms; PCD write {out['pcd_write_ms']:.2f} / "
        f"read {out['pcd_read_ms']:.2f} ms; every round trip equal "
        f"[{card_line}]")
    return out


def phase_apriltag(card_line):
    """The twelfth slice (docstring 18): AprilTag detect → pose at 1080p,
    the dense CCL and the host formats. No hand kernel runs."""
    t_phase = time.perf_counter()
    gray, truth = tag_scene()
    g_dev = torch.as_tensor(gray, device=DEV)
    dec = apriltag.AprilTagDecoder(device=DEV)
    dets, rows = _tag_detection(card_line, gray, truth, dec)
    thr_card, parity = _tag_parity(gray, g_dev, dets)
    summary = {"tags": rows, "parity": parity,
               "times": _tag_times(card_line, gray, g_dev, dec),
               "dense_ccl": _dense_ccl(card_line, thr_card),
               "formats": _host_formats(card_line)}
    log(f"apriltag: {json.dumps(summary)}")
    log(f"apriltag phase: {time.perf_counter() - t_phase:.1f} s "
        f"[{card_line}]")
    return summary


# --------------------------------------------------------------------------
# the thirteenth slice: io and VLM serving
# --------------------------------------------------------------------------

# tests/test_io.py:42-50: mean |error| of a JPEG q95 round trip of a
# smooth image
JPEG_SMOOTH_CORRIDOR = 4.0
# the same round trip of the textured imgproc frame (6-px blocks of noise,
# σ 6): JPEG drops the noise; 12.96 on the CPU before any chip run
JPEG_TEXTURED_BOUND = 16.0
MJPEG_FRAMES = 60
MJPEG_MEAN_ERR = 12.0          # tests/test_io.py's per-frame corridor
TUM_DEPTH_SCALE = 5000.0


def _ms_since(t0: float) -> float:
    return (time.perf_counter() - t0) * 1e3


def _tum_layout(root, frames, gt):
    """The frames as TUM RGB-D: rgb/*.png (the gray frame in 3 channels),
    depth/*.png (u16, a seed-made plane at 2.7–5 m, 5000 ticks a metre),
    rgb.txt, depth.txt and groundtruth.txt (tx ty tz qx qy qz qw). Returns
    the depth maps in metres as the reader computes them."""
    os.makedirs(os.path.join(root, "rgb"))
    os.makedirs(os.path.join(root, "depth"))
    h, w = frames[0].shape
    ramp = np.linspace(2.7, 5.0, w)[None, :].repeat(h, 0)
    lines = {"rgb": ["# rgb"], "depth": ["# depth"], "gt": ["# gt"]}
    depths = []
    for i, (f, pose) in enumerate(zip(frames, gt)):
        t = 1305031102.0 + i / 30.0
        d16 = np.round((ramp + 0.01 * i) * TUM_DEPTH_SCALE).astype(np.uint16)
        kio.write_image_png(os.path.join(root, "rgb", f"{t:.6f}.png"),
                            np.repeat(f[:, :, None], 3, 2))
        kio.write_image_png(os.path.join(root, "depth", f"{t:.6f}.png"), d16)
        lines["rgb"].append(f"{t:.6f} rgb/{t:.6f}.png")
        lines["depth"].append(f"{t + 0.002:.6f} depth/{t:.6f}.png")
        q, tr = pose[:4], pose[4:]
        lines["gt"].append(" ".join([f"{t:.6f}"] + [repr(float(v)) for v in (
            *tr, q[1], q[2], q[3], q[0])]))
        depths.append(d16.astype(np.float32) / TUM_DEPTH_SCALE)
    for name, fname in (("rgb", "rgb.txt"), ("depth", "depth.txt"),
                        ("gt", "groundtruth.txt")):
        with open(os.path.join(root, fname), "w") as fh:
            fh.write("\n".join(lines[name]) + "\n")
    return depths


def _datasets_case(tmp, frames, gt):
    """TUM (40 frames), EuRoC and KITTI (5 frames) written and read back."""
    out = {}
    t0 = time.perf_counter()
    depths = _tum_layout(os.path.join(tmp, "tum"), frames, gt)
    out["tum_write_ms"] = _ms_since(t0)
    t0 = time.perf_counter()
    ds = kio.TumRgbdDataset(os.path.join(tmp, "tum"))
    got = [ds[i] for i in range(len(ds))]
    out["tum_read_ms"] = _ms_since(t0)
    if len(ds) != len(frames) or any(
            not np.array_equal(g.rgb[:, :, 0], f) or
            not np.array_equal(g.depth, d)
            for g, f, d in zip(got, frames, depths)):
        raise AssertionError("TUM RGB-D: frames or depth differ")
    if not np.array_equal(ds.groundtruth["poses"], gt):
        raise AssertionError("TUM RGB-D: ground-truth poses differ")
    # EuRoC: mav0/cam0/data.csv + data/, ns stamps; KITTI: image_0, times
    root = os.path.join(tmp, "euroc", "mav0", "cam0")
    os.makedirs(os.path.join(root, "data"))
    rows = ["#timestamp [ns],filename"]
    kroot = os.path.join(tmp, "kitti", "sequences", "00")
    os.makedirs(os.path.join(kroot, "image_0"))
    for i, f in enumerate(frames[:5]):
        ts = 1403636579763555584 + i * 50_000_000
        kio.write_image_png(os.path.join(root, "data", f"{ts}.png"), f)
        rows.append(f"{ts},{ts}.png")
        kio.write_image_png(os.path.join(kroot, "image_0", f"{i:06d}.png"), f)
    with open(os.path.join(root, "data.csv"), "w") as fh:
        fh.write("\n".join(rows) + "\n")
    with open(os.path.join(kroot, "times.txt"), "w") as fh:
        fh.write("".join(f"{0.1 * i:.6f}\n" for i in range(5)))
    eu = kio.EurocDataset(os.path.join(tmp, "euroc"))
    ki = kio.KittiOdometryDataset(os.path.join(tmp, "kitti"), "00")
    for name, d in (("EuRoC", eu), ("KITTI", ki)):
        if len(d) != 5 or any(not np.array_equal(d[i].gray, frames[i])
                              for i in range(5)):
            raise AssertionError(f"{name}: frames differ")
    if abs(eu.timestamps[1] - eu.timestamps[0] - 0.05) > 1e-6:
        raise AssertionError("EuRoC: timestamps")
    return out


def _codec_case(tmp, frame):
    """The 1080p frame through every codec: write and read ms, equality or
    the JPEG corridors. Returns the rows and the JPEG's path."""
    rows = {}
    cases = (("png", kio.write_image_png, kio.read_image_png_rgb8),
             ("tif", kio.write_image_tiff, kio.read_image_tiff),
             ("webp", lambda p, a: kio.write_image_webp(p, a, lossless=True),
              kio.read_image_webp_rgb8),
             ("jpg", lambda p, a: kio.write_image_jpeg(p, a, quality=95),
              kio.read_image_jpeg_rgb8))
    for ext, write, read in cases:
        path = os.path.join(tmp, f"frame.{ext}")
        t0 = time.perf_counter()
        write(path, frame)
        w_ms = _ms_since(t0)
        t0 = time.perf_counter()
        back = read(path)
        r_ms = _ms_since(t0)
        err = float(np.abs(back.astype(np.int32) - frame).mean())
        rows[ext] = {"write_ms": w_ms, "read_ms": r_ms, "mean_abs_err": err,
                     "bytes": os.path.getsize(path)}
        if ext != "jpg" and not np.array_equal(back, frame):
            raise AssertionError(f"{ext}: the lossless round trip differs")
    if rows["jpg"]["mean_abs_err"] >= JPEG_TEXTURED_BOUND:
        raise AssertionError(f"jpeg q95 of the textured frame: mean error "
                             f"{rows['jpg']['mean_abs_err']}")
    hh, ww = frame.shape[:2]
    yy, xx = np.mgrid[0:hh, 0:ww]
    smooth = np.stack([xx * 255 // (ww - 1), yy * 255 // (hh - 1),
                       (xx + yy) * 255 // (hh + ww - 2)], -1).astype(np.uint8)
    path = os.path.join(tmp, "smooth.jpg")
    kio.write_image_jpeg(path, smooth, quality=95)
    err = float(np.abs(kio.read_image_jpeg_rgb8(path).astype(np.int32)
                       - smooth).mean())
    rows["jpg_smooth"] = {"mean_abs_err": err}
    if err >= JPEG_SMOOTH_CORRIDOR:
        raise AssertionError(f"jpeg q95 of a smooth 1080p image: mean error "
                             f"{err}")
    return rows, os.path.join(tmp, "frame.jpg")


def mjpeg_frames(n: int = MJPEG_FRAMES, h: int = H, w: int = W):
    """tests/test_io.py's clip at 480×752: gradients and a square that
    moves 6 px a frame, the blue level rising 3 a frame."""
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        f = np.stack([xx * 255 / (w - 1), yy * 255 / (h - 1),
                      np.full((h, w), 40.0 + 3 * i)], -1).astype(np.uint8)
        x0 = 4 + 6 * i
        f[100:200, x0:x0 + 80] = (220, 40, 40)
        out.append(f)
    return out


def _mjpeg_case(tmp):
    frames = mjpeg_frames()
    path = os.path.join(tmp, "clip.avi")
    t0 = time.perf_counter()
    with kio.VideoWriter(path, fps=30.0, size_hw=(H, W), codec="mjpg") as wr:
        for f in frames:
            wr.write(f)
    out = {"write_ms_per_frame": _ms_since(t0) / len(frames),
           "bytes": os.path.getsize(path)}
    for name, reader in (("MjpegReader", kio.MjpegReader(path)),
                         ("VideoReader (cv2)", kio.VideoReader(path))):
        if reader.n_frames != len(frames) or abs(reader.fps - 30.0) > 0.1:
            raise AssertionError(f"{name}: {reader.n_frames} frames at "
                                 f"{reader.fps} fps")
        t0 = time.perf_counter()
        got = list(reader)
        ms = _ms_since(t0) / len(frames)
        reader.release()
        errs = [float(np.abs(g.astype(np.int32) - f).mean())
                for g, f in zip(got, frames)]
        if len(got) != len(frames) or max(errs) >= MJPEG_MEAN_ERR:
            raise AssertionError(f"{name}: {len(got)} frames, mean error "
                                 f"up to {max(errs)}")
        out[name] = {"read_ms_per_frame": ms, "max_mean_abs_err": max(errs)}
    if kio.MjpegReader(path).size != (H, W):
        raise AssertionError("MjpegReader: size")
    return out, path


def _capture_case(tmp, frames):
    import ctypes
    from kornia_tpu_torch.native import load_native_library

    lib = load_native_library()
    fn = lib.kornia_image_write_pnm
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
    root = os.path.join(tmp, "cam")
    os.makedirs(root)
    for i, f in enumerate(frames):
        c = np.ascontiguousarray(f)
        if fn(os.path.join(root, f"f{i:03d}.ppm").encode(),
              c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), H, W, 3):
            raise AssertionError("kornia_image_write_pnm failed")
    with kio.NativeCapture("dir:" + root) as cap:
        t0 = time.perf_counter()
        got = [cap.grab_frame() for _ in range(len(frames) + 2)]
        ms = _ms_since(t0) / len(got)
    if any(not np.array_equal(g, frames[i % len(frames)])
           for i, g in enumerate(got)):
        raise AssertionError("NativeCapture: frames differ")
    return {"grab_ms_per_frame": ms, "frames": len(got)}


def phase_io(card_line, tmp):
    """The thirteenth slice's io (docstring 19), in ``tmp``. Returns the
    1080p JPEG's and the AVI's paths for the vlm phase."""
    t_phase = time.perf_counter()
    frames, gt, _ = slam_sequence()
    summary = {"datasets": _datasets_case(tmp, frames, gt)}
    summary["codecs"], jpeg = _codec_case(tmp, imgproc_frame())
    summary["mjpeg"], avi = _mjpeg_case(tmp)
    summary["capture"] = _capture_case(tmp, mjpeg_frames(5))
    for ext, row in summary["codecs"].items():
        log(f"io {ext}: " + ", ".join(f"{k} {v:.4g}" for k, v in row.items())
            + " (1080p)")
    for name in ("MjpegReader", "VideoReader (cv2)"):
        log(f"io mjpeg {name}: write {summary['mjpeg']['write_ms_per_frame']:.3f}"
            f" ms a frame, read {summary['mjpeg'][name]['read_ms_per_frame']:.3f}"
            f" ms a frame, mean |error| ≤ "
            f"{summary['mjpeg'][name]['max_mean_abs_err']:.3f} (480×752, "
            f"{MJPEG_FRAMES} frames)")
    log(f"io: {json.dumps(summary)}")
    log(f"io phase: {time.perf_counter() - t_phase:.1f} s [{card_line}]")
    return jpeg, avi


VLM_LOGIT_TOL = 1e-3          # card against the CPU route, |logit| ≈ 1-5
VLM_MARGIN = 10 * VLM_LOGIT_TOL
VLM_PROMPT_IDS = 10
VLM_NEW_TOKENS = 32
VLM_OTHER_TOKENS = 16
VLM_EOS = 2


def _text_flops(t, cache_len, c, prefix=False):
    """FLOPs of T tokens of the decoder from ``cache_len`` (2 a
    multiply-add): the projections and MLP, attention over the keys each
    query sees, and the tied-embedding logits of every token."""
    hd = c.head_dim
    per_tok = (c.hidden_size * (c.num_heads + 2 * c.num_kv_heads) * hd
               + c.num_heads * hd * c.hidden_size
               + 3 * c.hidden_size * c.intermediate_size)
    keys = (t * (cache_len + t) if prefix
            else t * cache_len + t * (t + 1) // 2)
    attn = 4 * c.num_heads * hd * keys
    return (2 * per_tok * t + attn) * c.num_layers \
        + 2 * t * c.hidden_size * c.vocab_size


def _vision_flops(v, n_img, out_width):
    n = (v.image_size // v.patch_size) ** 2
    per_tok = (3 * v.hidden_size * v.hidden_size + v.hidden_size ** 2
               + 2 * v.hidden_size * v.intermediate_size)
    layers = v.num_layers * (2 * per_tok * n + 4 * n * n * v.hidden_size)
    patch = 2 * n * v.patch_size ** 2 * 3 * v.hidden_size
    return n_img * (layers + patch + 2 * n * v.hidden_size * out_width)


def _text_weight_bytes(c, elem=4):
    """The decoder's weights a decode step reads (layers, final norm and
    the tied embedding as the logits' matrix)."""
    hd = c.head_dim
    per_layer = (c.hidden_size * (c.num_heads + 2 * c.num_kv_heads) * hd
                 + c.num_heads * hd * c.hidden_size
                 + 3 * c.hidden_size * c.intermediate_size
                 + 2 * c.hidden_size)
    return elem * (c.num_layers * per_layer + c.hidden_size
                   + c.vocab_size * c.hidden_size)


def _timed_event() -> torch.cuda.Event:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _margin_check(label, cpu_logits, card_tokens, eos=VLM_EOS):
    """Hold the card's greedy tokens to the CPU's logits at each step
    (teacher-forced on the card's tokens): equal wherever the CPU's top-2
    margin exceeds VLM_MARGIN; steps under it are printed, not held.
    Stops at the first eos (later tokens are forced)."""
    top2 = torch.topk(cpu_logits.float(), 2, dim=-1)
    allowed = []
    for i, t in enumerate(card_tokens.tolist()):
        best = int(top2.indices[i, 0])
        margin = float(top2.values[i, 0] - top2.values[i, 1])
        if t != best:
            if margin > VLM_MARGIN:
                raise AssertionError(f"{label}: step {i}: card token {t}, "
                                     f"CPU {best} by a margin of {margin}")
            allowed.append((i, t, best, margin))
            log(f"vlm {label}: step {i}: card token {t}, CPU {best}, top-2 "
                f"margin {margin:.3g} < {VLM_MARGIN} (not held)")
        if t == eos:
            break
    return allowed


def _cpu_copy(model, cfg, build):
    """The model's weights in a CPU build of the same configuration."""
    cpu = build(cfg, device="meta")
    cpu.to_empty(device="cpu")
    cpu.load_state_dict(model.state_dict())
    return cpu


def _cpu_prefill(model, cpu, cfg, tokens, images, label):
    """Prefill logits of the card against the CPU copy, held to
    VLM_LOGIT_TOL; returns (error, max |logit|, the CPU's logits and
    cache)."""
    tok_c, img_c = tokens.cpu(), images.cpu()
    b = tok_c.shape[0]
    with torch.inference_mode():
        t0 = time.perf_counter()
        lc, cache = cpu(tok_c, img_c,
                        models.KVCache.zeros(cfg.text, b, device="cpu"))
        cpu_s = time.perf_counter() - t0
        lg, _ = model(tokens, images,
                      models.KVCache.zeros(cfg.text, b, device=DEV))
    err = float((lg.cpu() - lc).abs().max())
    scale = float(lc.abs().max())
    log(f"vlm {label}: prefill logits card − CPU max |Δ| {err:.3g} "
        f"(max |logit| {scale:.3g}; tolerance {VLM_LOGIT_TOL}); CPU prefill "
        f"{cpu_s:.2f} s")
    if not err <= VLM_LOGIT_TOL:
        raise AssertionError(f"{label}: prefill logits differ by {err}")
    return err, scale, lc, cache


def _cpu_route(model, cpu, cfg, tokens, images, card_tokens, label):
    """The same weights on the CPU (``cpu``): prefill logits against the
    card's, and the card's greedy tokens against the CPU's teacher-forced
    logits."""
    err, scale, lc, cache = _cpu_prefill(model, cpu, cfg, tokens, images,
                                         label)
    with torch.inference_mode():
        forced = card_tokens[:, :-1].cpu().long()
        lf, _ = cpu.text(cpu.text.embed_tokens(forced), cache)
    steps = torch.cat([lc[0, -1:], lf[0]], 0)
    allowed = _margin_check(label, steps, card_tokens[0].cpu())
    return {"prefill_max_abs_err": err, "max_abs_logit": scale,
            "steps_below_margin": allowed}


def _serve(label, model, cfg, img, n_new, card_line, cpu_check=None):
    """One model: preprocess, encode, prefill, a greedy request with the
    stream callback, request times, per-step decode times and a traced
    request; gates on finiteness, n_generated and the stream.
    ``cpu_check(tokens, pixels, card_tokens)``, if given, holds the request
    to the CPU route. Returns the model's row.

    The decode figures come from ``models.generate`` itself: a forward
    hook on ``model.text`` (entered by the prefill, then once a decode
    step) holds every decoder call's logits finite and, in a timed run,
    records a CUDA event as each is entered, so the n − 2 spans between
    the decode steps' events are whole loop bodies (sampling, the eos
    bookkeeping, embedding, decoder). Launches and device time per step
    are the traced request's less those of a traced 2-token request,
    over n − 2."""
    c = cfg.text
    size = cfg.vision.image_size
    row = {}
    pix = models.preprocess_image(img, size, device=DEV)
    row["preprocess_ms"] = cuda_ms(lambda: models.preprocess_image(
        img, size, device=DEV), reps=5)
    rng = np.random.default_rng(SEED + 40)
    prompt = models.build_prompt_tokens(
        rng.integers(3, 49000, VLM_PROMPT_IDS).tolist(),
        cfg.tokens_per_image, cfg.image_token_id)
    tokens = torch.as_tensor(prompt[None]).long().to(DEV)
    with torch.inference_mode():
        row["vision_encode_ms"] = cuda_ms(lambda: model.encode_images(pix),
                                          reps=5)

        def prefill():
            return model(tokens, pix, models.KVCache.zeros(c, 1, device=DEV))

        row["prefill_ms"] = cuda_ms(prefill, reps=5)
    seen, finite = [], []
    hook = model.text.register_forward_hook(
        lambda _m, _a, out: finite.append(torch.isfinite(out[0]).all()))
    try:
        res = models.generate(model, prompt, pix, max_new_tokens=n_new,
                              eos_token_id=VLM_EOS,
                              stream_callback=seen.append, device=DEV)
    finally:
        hook.remove()
    if len(finite) != n_new or not bool(torch.stack(finite).all()):
        raise AssertionError(f"{label}: {len(finite)} decoder calls, logits "
                             f"finite {torch.stack(finite).tolist()}")
    toks = res.tokens.cpu().numpy()
    n_gen = res.n_generated.cpu().numpy()
    for r in range(toks.shape[0]):
        first = np.flatnonzero(toks[r] == VLM_EOS)
        want = first[0] if len(first) else n_new
        if n_gen[r] != want or not (toks[r, want:] == VLM_EOS).all():
            raise AssertionError(f"{label}: n_generated {n_gen[r]}, "
                                 f"tokens {toks[r].tolist()}")
    if seen != toks[0][: int(n_gen[0]) + 1].tolist():
        raise AssertionError(f"{label}: stream {seen} against "
                             f"{toks[0].tolist()}")

    def request(n=n_new):
        return models.generate(model, prompt, pix, max_new_tokens=n,
                               eos_token_id=VLM_EOS, device=DEV).tokens.cpu()

    reqs = []
    for _ in range(3):
        t0 = time.perf_counter()
        request()
        reqs.append(_ms_since(t0))
    row["request_ms"] = statistics.median(reqs)
    events = []
    hook = model.text.register_forward_pre_hook(
        lambda *_: events.append(_timed_event()))
    try:
        request()
    finally:
        hook.remove()
    step_ms = [events[i].elapsed_time(events[i + 1])
               for i in range(1, n_new - 1)]
    row["decode_ms_p50"] = _pct(step_ms, 50)
    row["decode_ms_p95"] = _pct(step_ms, 95)
    row["tokens_per_s"] = 1e3 / float(np.mean(step_ms))
    _, tr = _frame_trace(request)
    _, tr2 = _frame_trace(lambda: request(2))
    row["launches_per_decode_step"] = \
        (tr["launches"] - tr2["launches"]) / (n_new - 2)
    row["copies_per_decode_step"] = \
        (tr["copies"] - tr2["copies"]) / (n_new - 2)
    row["decode_device_ms"] = (tr["busy_ms"] - tr2["busy_ms"]) / (n_new - 2)
    row.update(traced_request_ms=tr["wall_ms"], launches=tr["launches"],
               host_syncs=tr["syncs"], sync_sites=tr["sync_sites"],
               busy_share=tr["busy_ms"] / tr["wall_ms"])
    n_prompt = tokens.shape[1]
    width = c.hidden_size
    vis = _vision_flops(cfg.vision, 1, width)
    pre = vis + _text_flops(n_prompt, 0, c,
                            prefix=isinstance(model, models.PaliGemma))
    dec = _text_flops(1, n_prompt + n_new // 2, c)
    wbytes = _text_weight_bytes(c)
    peak = 2 * RATES["f32"]
    row.update(
        prefill_flops=pre, decode_flops_per_token=dec,
        vision_flops=vis,
        vision_share_of_f32_peak=vis / (row["vision_encode_ms"] / 1e3) / peak,
        prefill_share_of_f32_peak=pre / ((row["vision_encode_ms"]
                                          + row["prefill_ms"]) / 1e3) / peak,
        decode_share_of_f32_peak=dec / (row["decode_ms_p50"] / 1e3) / peak,
        decode_weight_bytes=wbytes,
        decode_byte_bound_ms=wbytes / HBM_BYTES_PER_S * 1e3,
        tokens=toks[0].tolist(), n_generated=n_gen.tolist())
    log(f"vlm {label}: preprocess {row['preprocess_ms']:.3f} ms, vision "
        f"encode {row['vision_encode_ms']:.3f} ms ({vis / 1e12:.4f} TFLOP, "
        f"{row['vision_share_of_f32_peak']:.3f} of the f32 peak), prefill "
        f"{row['prefill_ms']:.3f} ms ({n_prompt} tokens; with the encode "
        f"{pre / 1e12:.4f} TFLOP, {row['prefill_share_of_f32_peak']:.3f}), "
        f"request {row['request_ms']:.1f} ms ({n_new} tokens); decode "
        f"{row['decode_ms_p50']:.3f} / {row['decode_ms_p95']:.3f} ms a token "
        f"p50 / p95 ({row['tokens_per_s']:.1f} tokens/s; device "
        f"{row['decode_device_ms']:.3f} ms, "
        f"{row['launches_per_decode_step']:g} launches and "
        f"{row['copies_per_decode_step']:g} copies a step; byte bound "
        f"{row['decode_byte_bound_ms']:.4f} ms "
        f"for {wbytes / 1e9:.3f} GB; {dec / 1e9:.3f} GFLOP, "
        f"{row['decode_share_of_f32_peak']:.4f} of the f32 peak); traced "
        f"request: {tr['launches']} launches, {tr['syncs']} host syncs "
        f"{tr['sync_sites']}, busy {row['busy_share']:.4f} [{card_line}]")
    if cpu_check is not None:
        row["cpu_route"] = cpu_check(tokens, pix, res.tokens)
    return row


def _other_model(label, build, cfg, img, card_line):
    """One greedy request of VLM_OTHER_TOKENS at full width, then the card
    against the CPU at 2 layers of depth, full width; freed after."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build(cfg, seed=SEED, device=DEV)
    torch.cuda.synchronize()
    build_ms = _ms_since(t0)
    row = _serve(label, model, cfg, img, VLM_OTHER_TOKENS, card_line)
    row.update(build_ms=build_ms,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    del model
    torch.cuda.empty_cache()
    cut = dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, num_layers=2),
        text=dataclasses.replace(cfg.text, num_layers=2))
    small = build(cut, seed=SEED, device=DEV)
    pix = models.preprocess_image(img, cut.vision.image_size, device=DEV)
    prompt = models.build_prompt_tokens(
        np.random.default_rng(SEED + 41).integers(3, 49000, VLM_PROMPT_IDS)
        .tolist(), cut.tokens_per_image, cut.image_token_id)
    res = models.generate(small, prompt, pix, max_new_tokens=VLM_OTHER_TOKENS,
                          eos_token_id=VLM_EOS, device=DEV)
    tokens = torch.as_tensor(prompt[None]).long().to(DEV)
    cpu = _cpu_copy(small, cut, build)
    row["cpu_route_2_layers"] = _cpu_route(small, cpu, cut, tokens, pix,
                                           res.tokens, f"{label} 2 layers")
    del small, cpu
    torch.cuda.empty_cache()
    log(f"vlm {label}: build {build_ms:.1f} ms, max_memory_allocated "
        f"{row['max_memory_allocated'] / 1e9:.3f} GB [{card_line}]")
    return row


def phase_vlm(card_line, jpeg, avi):
    """The thirteenth slice (docstring 20)."""
    t_phase = time.perf_counter()
    ck.reset_launch_counts()
    out = {}
    cfg = models.smolvlm_256m()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = models.build_vlm(cfg, seed=SEED, device=DEV)
    torch.cuda.synchronize()
    build_ms = _ms_since(t0)
    t0 = time.perf_counter()
    img = kio.read_image_any_rgb8(jpeg)
    read_ms = _ms_since(t0)

    cpu = _cpu_copy(model, cfg, models.build_vlm)

    def cpu_check(tokens, pix, card_tokens):
        return _cpu_route(model, cpu, cfg, tokens, pix, card_tokens,
                          "smolvlm_256m")

    row = _serve("smolvlm_256m image", model, cfg, img, VLM_NEW_TOKENS,
                 card_line, cpu_check=cpu_check)
    row.update(build_ms=build_ms, jpeg_read_ms=read_ms)
    out["smolvlm_256m"] = row
    # request 2: temperature 0.7, a seeded generator, twice
    pix = models.preprocess_image(img, 512, device=DEV)
    prompt = models.build_prompt_tokens(
        np.random.default_rng(SEED + 40).integers(3, 49000, VLM_PROMPT_IDS)
        .tolist(), cfg.tokens_per_image, cfg.image_token_id)
    sampled = [models.generate(
        model, prompt, pix, max_new_tokens=VLM_NEW_TOKENS,
        eos_token_id=VLM_EOS, temperature=0.7, seed=SEED,
        device=DEV).tokens.cpu() for _ in range(2)]
    if not torch.equal(sampled[0], sampled[1]):
        raise AssertionError("temperature 0.7: one seed, two answers")
    out["sampled"] = {"tokens": sampled[0][0].tolist(), "differs_from_greedy":
                      int((sampled[0][0] != torch.tensor(row["tokens"])).sum())}
    # request 3: the io phase's AVI, 4 sampled frames as 4 rows
    t0 = time.perf_counter()
    with kio.VideoReader(avi) as reader:
        sample = models.sample_video(reader, 4)
    sample_ms = _ms_since(t0)
    vpix = models.preprocess_video(sample, 512, device=DEV)
    vid_pre_ms = cuda_ms(lambda: models.preprocess_video(sample, 512,
                                                         device=DEV), reps=5)
    rows = np.repeat(prompt[None], 4, 0)
    with torch.inference_mode():
        venc_ms = cuda_ms(lambda: model.encode_images(vpix), reps=3)
    # each row's prefill against the CPU copy: a row that took another
    # row's image features would differ there
    verr = _cpu_prefill(model, cpu, cfg, torch.as_tensor(rows).long().to(DEV),
                        vpix, "smolvlm_256m video (4 rows)")[0]
    del cpu
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        vres = models.generate(model, rows, vpix,
                               max_new_tokens=VLM_NEW_TOKENS,
                               eos_token_id=VLM_EOS, device=DEV)
        vt = vres.tokens.cpu().numpy()
        times.append(_ms_since(t0))
    vn = vres.n_generated.cpu().numpy()
    for r in range(4):
        first = np.flatnonzero(vt[r] == VLM_EOS)
        if vn[r] != (first[0] if len(first) else VLM_NEW_TOKENS):
            raise AssertionError(f"video row {r}: n_generated {vn[r]}")
    out["video"] = {
        "sample_ms": sample_ms, "frames": len(sample),
        "timestamps": sample.metadata.timestamps,
        "preprocess_ms": vid_pre_ms, "vision_encode_ms": venc_ms,
        "prefill_max_abs_err_cpu": verr,
        "vision_share_of_f32_peak": _vision_flops(cfg.vision, 4, 576)
        / (venc_ms / 1e3) / (2 * RATES["f32"]),
        "request_ms": statistics.median(times), "n_generated": vn.tolist(),
        "rows_differ": int(len({tuple(r) for r in vt.tolist()}))}
    row["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    log(f"vlm smolvlm_256m: build {build_ms:.1f} ms, JPEG read {read_ms:.2f}"
        f" ms; temperature 0.7 twice equal, {out['sampled']['differs_from_greedy']}"
        f" of {VLM_NEW_TOKENS} tokens from greedy; video (4 rows): sample "
        f"{sample_ms:.1f} ms, preprocess {vid_pre_ms:.3f} ms, encode "
        f"{venc_ms:.3f} ms, request {out['video']['request_ms']:.1f} ms; "
        f"max_memory_allocated {row['max_memory_allocated'] / 1e9:.3f} GB "
        f"[{card_line}]")
    del model
    torch.cuda.empty_cache()
    for label, build, other in (
            ("paligemma", models.build_paligemma, models.PaliGemmaConfig()),
            ("smolvlm_500m", models.build_vlm, models.smolvlm_500m()),
            ("smolvlm_2_2b", models.build_vlm, models.smolvlm_2_2b())):
        out[label] = _other_model(label, build, other, img, card_line)
    if any(ck.LAUNCHES.values()):
        raise AssertionError(f"vlm: hand kernels launched: {ck.LAUNCHES}")
    log(f"vlm: {json.dumps(out)}")
    log(f"vlm phase: {time.perf_counter() - t_phase:.1f} s [{card_line}]")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", metavar="DIR",
                    help="the parent commit's tree: time its K1, K5, K8, "
                         "K9 and wrappers against this tree's, in turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; a GPU is "
                 "required")
    card_line = card()
    log(f"card: {card_line}")
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    sms, mhz = issue_rates()
    log(f"issue rates: {sms} SMs at {mhz:.0f} MHz max: f32 "
        f"{RATES['f32']:.4e}, int32 {RATES['int32']:.4e} ops/s")

    # 1. build
    build_s = ck.build()
    log(f"kernel build: {build_s:.2f} s ({len(ck.SOURCES)} sources, "
        f"one nvcc each, in parallel)")
    for name, text in ck.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "stack" in line:
                log(f"  {name}: {line.strip()}")
    parent = None
    if args.parent:
        t0 = time.perf_counter()
        parent = load_parent(args.parent)
        log(f"parent kernels from {args.parent}: built in "
            f"{time.perf_counter() - t0:.2f} s")

    img1, img2, r_gt, t_gt = render_scene()
    cfg = orb.OrbConfig()
    thr = cfg.fast_threshold_low
    budgets = orb._level_budgets(cfg)
    g1 = torch.as_tensor(img1, device=DEV)
    levels = orb._pyramid(g1, cfg)
    levels2 = orb._pyramid(torch.as_tensor(img2, device=DEV), cfg)
    shapes = [tuple(lv.shape) for lv in levels]
    log(f"levels: {shapes}; budgets {budgets}")

    # 2. kernels vs plain versions on the card
    errs = {}
    k1_err = 0.0
    for view in (levels, levels2):
        for (s_k, h_k), lv in zip(ck.fast_harris_levels(view, thr), view):
            s_p, h_p = ck._fast_harris_plain(lv, thr)
            s_1, h_1 = ck.fast_harris(lv, thr)
            torch.cuda.synchronize()
            if not torch.equal(s_k, s_p):
                raise AssertionError(f"fast_harris score/NMS differs at "
                                     f"{lv.shape}")
            if not torch.equal(h_k, h_p):
                raise AssertionError(f"fast_harris Harris differs at "
                                     f"{lv.shape}: "
                                     f"{float((h_k - h_p).abs().max())}")
            if not (torch.equal(s_k, s_1) and torch.equal(h_k, h_1)):
                raise AssertionError(f"fast_harris_levels differs from the "
                                     f"one-level call at {lv.shape}")
            if parent is not None and not all(
                    torch.equal(a, b) for a, b in zip(
                        parent.fast_harris(lv, thr), (s_k, h_k))):
                raise AssertionError(f"parent fast_harris differs at "
                                     f"{lv.shape}")
            k1_err = max(k1_err, float((s_k - s_p).abs().max()),
                         float((h_k - h_p).abs().max()))
    errs["fast_harris"] = k1_err
    log(f"K1 fast_harris_levels: score, NMS and Harris of all "
        f"{len(levels)} levels of both views in one launch each, bit-equal "
        f"to the plain version and to the one-level calls"
        + (" and to the parent's kernel" if parent is not None else ""))

    sels = [orb._select_level(lv, b, cfg, mp) for lv, b, mp in zip(
        levels, budgets, ck.fast_harris_levels(levels, thr))]
    xy_ints = [torch.round(s[0]).to(torch.int32) for s in sels]
    # force border keypoints into every level: corners and edges
    for i, (xy, lv) in enumerate(zip(xy_ints, levels)):
        lh, lw = lv.shape
        border = torch.tensor([[0, 0], [lw - 1, lh - 1], [lw - 1, 0],
                               [0, lh - 1], [lw // 2, 0], [0, lh // 2]],
                              dtype=torch.int32, device=DEV)
        xy_ints[i] = torch.cat([border, xy[len(border):]])
    grays_f = [lv.to(torch.float32) for lv in levels]
    canvas, starts = ck.prepare_window_canvas(grays_f)
    xy_c = torch.cat([x + torch.tensor([0, s], dtype=torch.int32,
                                       device=DEV)[None]
                      for x, s in zip(xy_ints, starts)]).contiguous()
    level_of = np.repeat(np.arange(len(budgets)), budgets)
    straddle = int(np.sum(level_of[0::2] != level_of[1::2]))
    if straddle == 0:
        raise AssertionError("no pair straddles two levels")
    w_k = ck.windows_paired(canvas, xy_c, W)
    w_p = ck._windows_paired_plain(canvas, xy_c, W)
    torch.cuda.synchronize()
    if not torch.equal(w_k, w_p):
        raise AssertionError("windows_paired differs from its plain version")
    errs["windows_paired"] = float((w_k - w_p).abs().max())
    log(f"K2 windows_paired: bit-equal, {xy_c.shape[0]} keypoints "
        f"({straddle} pairs straddle two levels), out {tuple(w_k.shape)}")

    ang = orb.orientation_from_windows_paired(w_k)
    rows, cols = orb._brief_tap_coords(ang, cfg.pattern_seed, cfg.pattern,
                                       half_w=32)
    k = ang.shape[0]
    rows = rows.reshape(k // 2, 1024).contiguous()
    cols = (cols.reshape(k // 2, 2, 512)
            + torch.tensor([0, 64], dtype=torch.int32,
                           device=DEV)[None, :, None]).reshape(
        k // 2, 1024).contiguous()
    b_k = ck.brief_sample(w_k, rows, cols)
    b_p = ck._brief_sample_plain(w_k, rows, cols)
    torch.cuda.synchronize()
    if not torch.equal(b_k, b_p):
        raise AssertionError("brief_sample differs from its plain version")
    errs["brief_sample"] = float((b_k - b_p).abs().max())
    log(f"K3 brief_sample (the index form): bit-equal, {tuple(b_k.shape)} "
        f"taps")
    rot = (w_k, torch.cos(ang), torch.sin(ang),
           orb._pattern_on(cfg.pattern, cfg.pattern_seed, DEV), "paired")
    bits_k = ck.brief_rotated(*rot)
    samp_k = ck.brief_rotated(*rot, out="samples")
    bits_p = ck._brief_rotated_plain(*rot)
    samp_p = ck._brief_rotated_plain(*rot, out="samples")
    torch.cuda.synchronize()
    if not (torch.equal(bits_k, bits_p) and torch.equal(samp_k, samp_p)):
        raise AssertionError("brief_rotated differs from its plain version")
    if not torch.equal(samp_k, b_k.reshape(k, 512)):
        raise AssertionError("brief_rotated samples differ from the index "
                             "form's")
    errs["brief_rotated"] = max(float((samp_k - samp_p).abs().max()),
                                max_err(bits_k, bits_p))
    log(f"K3 brief_rotated: bits {tuple(bits_k.shape)} and samples "
        f"{tuple(samp_k.shape)} bit-equal to the plain version, samples "
        f"bit-equal to brief_sample on _brief_tap_coords' indices")

    # 3. the slice at full size
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    run_pair(img1, img2, "cuda", gen)          # warm-up (cuBLAS, caches)
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    with Record("brief_from_windows_paired", orb) as rec_pair:
        f1, f2, m, res = run_pair(img1, img2, "cuda", gen)
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    log(f"launches for the pair: {launches}")
    only(launches, {"fast_harris": 2, "windows_paired": 4,
                    "brief_rotated": 2})
    n_bits = check_brief_calls(rec_pair.calls, "pair")
    if len(rec_pair.calls) != 2 or n_bits != 2 * cfg.n_features * 256:
        raise AssertionError("recorded describe calls of the pair")
    log(f"pair descriptors: both frames' {n_bits} bits through "
        f"brief_rotated equal the index form's (brief_sample on "
        f"_brief_tap_coords) on the same windows and angles")
    for f in (f1, f2):
        for name, t in f._asdict().items():
            if t.dtype.is_floating_point and not torch.isfinite(t).all():
                raise AssertionError(f"ORB {name} not finite")
        if tuple(f.descriptors.shape) != (cfg.n_features, 256):
            raise AssertionError("descriptor shape")
    r_est = res.rotation.double().cpu().numpy()
    t_est = res.translation.double().cpu().numpy()
    if not (np.isfinite(r_est).all() and np.isfinite(t_est).all()):
        raise AssertionError("pose not finite")
    n_matches = int(m.mask.sum())
    n_inl = int(res.n_inliers)
    rerr, terr = rot_err_deg(r_est, r_gt), dir_err_deg(t_est, t_gt)
    log(f"slice: keypoints {int(f1.mask.sum())}/{int(f2.mask.sum())}, "
        f"matches {n_matches}, inliers {n_inl}, homography "
        f"{bool(res.use_homography)}, rotation error {rerr:.4f} deg, "
        f"translation direction error {terr:.4f} deg")
    if not (rerr <= 0.5 and terr <= 5.0 and n_inl >= 100):
        raise AssertionError("pose outside the bounds (0.5 deg, 5 deg, "
                             ">= 100 inliers)")
    with PerLevelK1():
        q1, q2, qm, qres = run_pair(
            img1, img2, "cuda", torch.Generator(device=DEV).manual_seed(SEED))
    for fa, fb in ((f1, q1), (f2, q2)):
        for name in fa._fields:
            if not torch.equal(getattr(fa, name), getattr(fb, name)):
                raise AssertionError(f"ORB {name} differs from the route "
                                     f"with one K1 launch per level")
    if not (torch.equal(m.idx, qm.idx) and int(qres.n_inliers) == n_inl):
        raise AssertionError("matches or inliers differ from the route with "
                             "one K1 launch per level")
    log("pair: both frames' ORB features (xy, score, angle, octave, "
        "descriptors, mask), the matches and the inliers equal the route "
        "with one K1 launch per level")

    t0 = time.perf_counter()
    c1, c2, cm, _ = run_pair(img1, img2, "cpu")
    cpu_s = time.perf_counter() - t0
    lv_cpu = orb._pyramid(torch.as_tensor(img1), cfg) + orb._pyramid(
        torch.as_tensor(img2), cfg)
    lv_gpu = levels + orb._pyramid(torch.as_tensor(img2, device=DEV), cfg)
    px_diff = sum(int((a.cpu().int() - b.int()).abs().gt(0).sum())
                  for a, b in zip(lv_gpu, lv_cpu))
    px_max = max(int((a.cpu().int() - b.int()).abs().max())
                 for a, b in zip(lv_gpu, lv_cpu))
    px_all = sum(b.numel() for b in lv_cpu)
    kp_diff = kp_all = bit_diff = bit_all = 0
    for fg, fc in ((f1, c1), (f2, c2)):
        same = ((fg.xy.cpu() == fc.xy).all(1)
                & (fg.mask.cpu() == fc.mask))
        kp_diff += int((~same).sum())
        kp_all += same.numel()
        both = same & fc.mask
        bit_diff += int((fg.descriptors.cpu()[both]
                         != fc.descriptors[both]).sum())
        bit_all += int(both.sum()) * 256
    match_same = float((m.idx.cpu() == cm.idx).float().mean())
    log(f"card vs cpu ({cpu_s:.1f} s on the CPU): pyramid pixels differing "
        f"{px_diff}/{px_all} = {px_diff / px_all:.3e} (max |diff| {px_max} "
        f"LSB); keypoints differing {kp_diff}/{kp_all} = "
        f"{kp_diff / kp_all:.4f}; descriptor bits differing "
        f"{bit_diff}/{bit_all} = {bit_diff / max(bit_all, 1):.3e}; "
        f"match idx equal {match_same:.4f}")
    if kp_diff / kp_all > 0.01:
        raise AssertionError("more than 1% of keypoints differ from the "
                             "CPU run")

    # 4. times
    hc, wc = canvas.shape
    xy_pad = xy_c.long()
    ri = (xy_pad[:, 1, None] + torch.arange(40, device=DEV)).clamp(max=hc - 1)
    ci = (xy_pad[:, 0, None] + 32 + torch.arange(64, device=DEV)).clamp(
        max=wc - 1)
    ri2 = ri.reshape(-1, 2, 40).permute(0, 2, 1)[:, :, :, None]   # (K/2,40,2,1)
    ci2 = ci.reshape(-1, 2, 64)[:, None, :, :]                    # (K/2,1,2,64)
    lib_k2 = canvas[ri2, ci2].reshape(-1, 40, 128)
    if not torch.equal(lib_k2, w_k):
        raise AssertionError("K2 library gather disagrees")
    flat_idx = (rows.long() * 128 + cols.long())
    wflat = w_k.reshape(w_k.shape[0], -1)
    if not torch.equal(torch.gather(wflat, 1, flat_idx), b_k):
        raise AssertionError("K3 library gather disagrees")
    HOST_CASES["fast_harris"] = lambda mod: mod.fast_harris_levels(levels,
                                                                   thr)
    HOST_CASES["windows_paired"] = lambda mod: mod.windows_paired(canvas,
                                                                  xy_c, W)
    HOST_CASES["brief_rotated"] = lambda mod: mod.brief_rotated(*rot)
    t_k1 = kernel_times(
        lambda: ck.fast_harris_levels(levels, thr),
        lambda: [ck._fast_harris_plain(lv, thr) for lv in levels])
    k1_new, k1_per_level = in_turns(
        lambda: ck.fast_harris_levels(levels, thr),
        lambda: [ck.fast_harris(lv, thr) for lv in levels])
    t_k1["before_device_ms"] = k1_per_level["device"]
    t_k1["before_call_ms"] = k1_per_level["call"]
    if parent is not None:
        k1_new_p, k1_parent = in_turns(
            lambda: ck.fast_harris_levels(levels, thr),
            lambda: [parent.fast_harris(lv, thr) for lv in levels])
        t_k1["parent_device_ms"] = k1_parent["device"]
        t_k1["parent_call_ms"] = k1_parent["call"]
    t_k2 = kernel_times(
        lambda: ck.windows_paired(canvas, xy_c, W),
        lambda: ck._windows_paired_plain(canvas, xy_c, W),
        lambda: canvas[ri2, ci2])
    t_k3i = kernel_times(
        lambda: ck.brief_sample(w_k, rows, cols),
        lambda: ck._brief_sample_plain(w_k, rows, cols),
        lambda: torch.gather(wflat, 1, flat_idx))
    t_k3 = kernel_times(
        lambda: ck.brief_rotated(*rot),
        lambda: ck._brief_rotated_plain(*rot),
        lambda: torch.gather(wflat, 1, flat_idx))
    chain_dev = device_ms(lambda: brief_index_form(w_k, ang))
    chain_call = cuda_ms(lambda: brief_index_form(w_k, ang))
    trig_dev = device_ms(lambda: (torch.cos(ang), torch.sin(ang)))

    # bounds from this run's inputs
    px = sum(a * b for a, b in shapes)
    # per pixel, the fewest card operations: integer, 16 ring differences;
    # per side (min for brighter, max for darker) 16 arcs of 3 and 16 arcs
    # of 9 (three arcs of 3), then the best of the 16 arcs in 8, each one
    # three-way min/max (one sm_90a instruction, at the int32 rate); 3 for
    # the score and threshold. f32: 9 for the NMS; Harris: 4 for the
    # gradients, 3 products, 3×(5+5) multiplies and 3×(4+4) adds for the
    # window, 6 for det/trace/response.
    k1_int = px * (16 + 2 * (16 + 16 + 8) + 3)
    k1_f32 = px * (9 + 4 + 3 + 54 + 6)
    k1_bytes = px * (1 + 4 + 4)
    # canvas values the windows cover, each read once
    touched = torch.zeros_like(canvas, dtype=torch.bool)
    touched[ri2, ci2] = True
    k2_bytes = (int(touched.sum()) * 4 + xy_c.numel() * 4
                + w_k.numel() * 4)
    uniq = torch.unique(flat_idx + torch.arange(
        flat_idx.shape[0], device=DEV)[:, None] * 5120).numel()
    k3i_bytes = uniq * 4 + rows.numel() * 4 * 2 + b_k.numel() * 4
    # brief_rotated touches the same taps (its samples equal the index
    # form's): those window values once, cos, sin, the pattern, the bits.
    # What its design moves, every window staged whole, is reported apart.
    k3_bytes = uniq * 4 + ang.numel() * 8 + 256 * 16 + bits_k.numel()
    k3_staged = (w_k.numel() * 4 + ang.numel() * 8 + 256 * 16
                 + bits_k.numel())

    rows_out = []
    # K3's row is its brief_rotated entry, which the path runs
    for name, n_launch, times, (bms, by) in (
            ("fast_harris", launches["fast_harris"], t_k1,
             bound(k1_bytes, k1_int, k1_f32)),
            ("windows_paired", launches["windows_paired"], t_k2,
             bound(k2_bytes)),
            ("brief_sample", launches["brief_rotated"], t_k3,
             bound(k3_bytes))):
        src, rep = KERNELS[name]
        rows_out.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": n_launch, "max_abs_err": errs[name],
            "bound_ms": bms, "bound_by": by, **times})
        log(f"time {name}: {fmt_times(times)}, bound {bms:.5f} ms ({by}) "
            f"[{card_line}]")
    k1 = rows_out[0]
    k1_bounds = (bound(k1_bytes)[0], k1_int / RATES["int32"] * 1e3,
                 k1_f32 / RATES["f32"] * 1e3)
    log(f"time fast_harris, all {len(levels)} levels of one frame in turns "
        f"(one launch per level, one launch, one launch, one launch per "
        f"level): one launch device {k1_new['device']} ms / call "
        f"{k1_new['call']} ms; one launch per level device "
        f"{k1_per_level['device']} ms / call {k1_per_level['call']} ms"
        + (f"; the parent's kernel, one launch per level, in turns with "
           f"one launch: device {k1_parent['device']} ms / call "
           f"{k1_parent['call']} ms (one launch {k1_new_p['device']} / "
           f"{k1_new_p['call']})" if parent is not None else "")
        + f"; bound {k1['bound_ms']:.5f} ms ({k1['bound_by']}: bytes "
        f"{k1_bounds[0]:.5f}, {k1_int} int32 ops {k1_bounds[1]:.5f}, "
        f"{k1_f32} f32 ops {k1_bounds[2]:.5f} ms at the issue rates) "
        f"[{card_line}]")
    k3 = rows_out[-1]
    k3["launches_by_entry"] = {"brief_rotated": launches["brief_rotated"],
                               "brief_sample": launches["brief_sample"]}
    k3["max_abs_err"] = max(errs["brief_sample"], errs["brief_rotated"])
    k3["entries"] = {"brief_rotated": errs["brief_rotated"],
                     "brief_sample": errs["brief_sample"]}
    bms, by = bound(k3i_bytes)
    k3["cases"] = [
        {"case": "brief_rotated, paired, 1000 x (40, 128) windows",
         "max_abs_err": errs["brief_rotated"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "staged_ms": bound(k3_staged)[0],
         **t_k3},
        {"case": "brief_sample (index form), 1000 x 1024 taps",
         "max_abs_err": errs["brief_sample"], "bound_ms": bms,
         "bound_by": by, **t_k3i}]
    log(f"  brief_sample's row is its brief_rotated entry: bound from "
        f"{k3_bytes} B (the {uniq} window values the taps touch, cos, sin, "
        f"pattern, bits); the design stages every window whole, {k3_staged} "
        f"B = {bound(k3_staged)[0]:.5f} ms at the memory rate")
    log(f"time brief_sample, the index form alone (ready int32 rows and "
        f"cols): {fmt_times(t_k3i, 'torch.gather (int64 indices ready)')}, "
        f"bound {bms:.5f} ms ({by}) [{card_line}]")
    log(f"time BRIEF chain before (_brief_tap_coords + brief_sample + "
        f"compare, 2000 keypoints paired): device {chain_dev:.4f} ms / call "
        f"{chain_call:.4f} ms; after: torch.cos + torch.sin device "
        f"{trig_dev:.4f} ms, brief_rotated device {t_k3['device_ms']:.4f} "
        f"ms / call {t_k3['call_ms']:.4f} ms [{card_line}]")
    log("  (fast_harris times and bound cover the 8 levels of one frame; "
        "windows_paired and brief_sample (its brief_rotated entry, which "
        "the path runs) one call at 2000 keypoints; the library call of "
        "brief_sample is torch.gather on ready int64 indices, which "
        "computes less; every "
        "input is under 50 MB, so repeated calls find it in L2, as the real "
        "callers find the windows just written and the frame just uploaded)")

    def stage(name, fn, reps=REPS):
        ms = cuda_ms(fn, reps=reps)
        log(f"stage {name}: {ms:.3f} ms [{card_line}]")
        return ms

    stage("pyramid (1 frame)", lambda: orb._pyramid(g1, cfg))

    def select(per_level):
        maps = ([None] * len(levels) if per_level
                else ck.fast_harris_levels(levels, thr))
        return [orb._select_level(lv, b, cfg, mp)
                for lv, b, mp in zip(levels, budgets, maps)]

    # before / after in turns, so that both see the same machine
    for per_level in (True, False, False, True):
        stage("detect+select, 8 levels (1 frame), "
              + ("one K1 launch per level" if per_level
                 else "one K1 launch"), lambda: select(per_level))
    stage("blur, 8 levels (1 frame)",
          lambda: [gaussian_blur(g, (7, 7), 2.0) for g in grays_f])
    blurs = [gaussian_blur(g, (7, 7), 2.0) for g in grays_f]

    def describe():
        a = orb.orientation_from_windows_paired(
            orb._extract_windows_packed_paired(grays_f, xy_ints))
        return orb.brief_from_windows_paired(
            orb._extract_windows_packed_paired(blurs, xy_ints), a,
            cfg.pattern_seed, cfg.pattern)

    def one_frame():
        return orb.orb_detect_and_describe(img1, cfg, device="cuda")

    # before / after in turns, so that both see the same machine
    with IndexFormBrief():
        stage("describe (1 frame), BRIEF by the index form", describe, 100)
    stage("describe (1 frame)", describe, 100)
    stage("describe (1 frame)", describe, 100)
    with IndexFormBrief():
        stage("describe (1 frame), BRIEF by the index form", describe, 100)
        stage("orb_detect_and_describe (1 frame), BRIEF by the index form",
              one_frame)
    stage("orb_detect_and_describe (1 frame)", one_frame)
    stage("orb_detect_and_describe (1 frame)", one_frame)
    with IndexFormBrief():
        stage("orb_detect_and_describe (1 frame), BRIEF by the index form",
              one_frame)
    stage("match_descriptors", lambda: matching.match_descriptors(
        f1.descriptors, f2.descriptors, a_mask=f1.mask, b_mask=f2.mask,
        max_distance=64, ratio=0.8, device="cuda"))
    x1, x2, mk = matching.matched_points(f1.xy, f2.xy, m)
    stage("estimate_relative_pose", lambda: twoview.estimate_relative_pose(
        x1, x2, K_EUROC, K_EUROC, mask=mk, params=twoview.TwoViewParams(),
        generator=torch.Generator(device=DEV).manual_seed(SEED),
        device="cuda"))
    def pair():
        return run_pair(img1, img2, "cuda",
                        torch.Generator(device=DEV).manual_seed(SEED))

    for per_level in (True, False, False, True):
        if per_level:
            with PerLevelK1():
                stage("whole pair, one K1 launch per level", pair)
        else:
            stage("whole pair", pair)
    device_share("whole pair", lambda: run_pair(
        img1, img2, "cuda", torch.Generator(device=DEV).manual_seed(SEED)),
        card_line)

    # 5-8. the warping slice
    k7 = phase_rectify(card_line)
    k7["cases"] = phase_warp(card_line)
    k7["max_abs_err"] = max([k7["max_abs_err"]]
                            + [c["max_abs_err"] for c in k7["cases"]])
    k8 = phase_lane_shift(card_line, parent)
    k9, k9y = phase_shear(card_line, parent)

    # 9-11. the third slice
    k4, k5, k3u, feats = phase_orb_variants(card_line, img1, parent)
    phase_orb_levels17(card_line, img1)
    k3["cases"].append({k: k3u[k] for k in ("case", "max_abs_err", "bound_ms",
                                            "bound_by", "staged_ms")
                        + TIME_KEYS})
    lk_cases, lk_paths, lk_remaps = phase_lk(card_line, img1, feats)
    k4["cases"] += lk_cases
    k4["paths"].update(lk_paths)
    k4["launches"] = sum(k4["paths"].values())
    k4["max_abs_err"] = max(c["max_abs_err"] for c in k4["cases"])
    k7["paths"] = {"rectify": k7["launches"], **lk_remaps}
    k7["launches"] = sum(k7["paths"].values())
    k6 = phase_preprocess(card_line)
    # 16. the tenth slice: the FAST detector path and the dense chain
    k1_cases, k1_fast_detect = phase_imgproc(card_line)
    # 17. the eleventh slice: FAST-n, 5-point, ICP, augmentations, depth
    k1_arc_cases, k1_arc_launches, k7_new = phase_geometry15b(card_line)
    k7["paths"].update(k7_new)
    k7["launches"] = sum(k7["paths"].values())
    # 18. the twelfth slice: AprilTag, the dense CCL, the host formats
    phase_apriltag(card_line)
    # 19-20. the thirteenth slice: io, then VLM serving from its files
    with tempfile.TemporaryDirectory() as tmp:
        jpeg, avi = phase_io(card_line, tmp)
        phase_vlm(card_line, jpeg, avi)

    # 13. the tracking step (the seventh slice)
    track_launches, track_errs = phase_track(card_line)
    for row in rows_out[:3]:
        key = {"brief_sample": "brief_rotated"}.get(row["name"], row["name"])
        row["launches_by_path"] = {"pair": row["launches"],
                                   "track frame": track_launches[key]}
        row["max_abs_err"] = max(row["max_abs_err"], track_errs[key])
    # 14. the SLAM back end (the eighth slice)
    phase_backend(card_line)
    # 15. the SLAM frame loop (the ninth slice)
    slam_launches, slam_errs, slam_summ = phase_slam(card_line)
    # 21. the fourteenth slice: the distributed layer
    par = phase_parallel(card_line, slam_summ)
    for row in rows_out[:3]:
        key = {"brief_sample": "brief_rotated"}.get(row["name"], row["name"])
        row["launches_by_path"]["slam loop"] = slam_launches[key]
        row["launches_by_path"]["frontend_dist (per rank)"] = \
            par["front"][key]
        row["launches_by_path"][
            f"slam loop, mesh of {PAR_RANKS} (rank 0)"] = par["slam"][key]
        row["max_abs_err"] = max(row["max_abs_err"], slam_errs[key],
                                 par["errs"][key])
    # K1's score-only entry (fast_score) on the fast_detector path
    k1 = rows_out[0]
    k1["launches_by_path"]["fast_detect (score-only entry)"] = \
        k1_fast_detect
    k1["launches_by_path"]["fast_detect arc lengths 9-12"] = k1_arc_launches
    k1["cases"] = k1_cases + k1_arc_cases
    host = phase_host(card_line, parent)
    for c in k5["cases"]:
        c["host_us_turns"] = host["lane_gather" + (
            " broadcast" if c["case"].startswith("broadcast") else "")]
    keep = ("mode", "launches", "max_abs_err", "bound_ms", "bound_by") \
        + TIME_KEYS \
        + BEFORE_KEYS + EXTRA_KEYS
    for name, row in (("windows", k4), ("lane_gather", k5),
                      ("preprocess", k6), ("remap", k7), ("lane_shift", k8),
                      ("shear_x", k9), ("shear_y", k9y)):
        src, rep = KERNELS[name]
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": rep}
        entry.update({k: row[k] for k in keep if k in row})
        if "cases" in row:
            entry["cases"] = [{k: c[k] for k in ("case",) + keep if k in c}
                              for c in row["cases"]]
        if "paths" in row:
            entry["launches_by_path"] = row["paths"]
        rows_out.append(entry)
    for row in rows_out:
        row["host_us_turns"] = host[{
            "brief_sample": "brief_rotated"}.get(row["name"], row["name"])]
    for row in rows_out:
        if row["launches"] < 1 or \
                row["max_abs_err"] > PLAIN_TOL.get(row["name"], 0.0):
            raise AssertionError(f"kernel {row['name']}: launches "
                                 f"{row['launches']}, max_abs_err "
                                 f"{row['max_abs_err']}")

    log(f"device times: {TRACE_STATS['traces']} profiler traces, "
        f"{TRACE_STATS['again']} of them taken again; the tracer lost "
        f"{TRACE_STATS['lost']} device records, none of them of a call "
        f"that a kept trace reads; every time taken has the "
        f"device record of each launch and copy of its {REPS} calls")
    log(json.dumps({"kernels": rows_out}))
    log(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
