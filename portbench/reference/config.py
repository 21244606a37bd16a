# Frozen copy of alego_tpu_torch/config.py for the benchmark's reference: plain
# PyTorch only, its imports made local; see portbench/reference/__init__.py.
"""Typed, hashable configuration for the TPU-native A-LeGO-LOAM engine.

The reference keeps its configuration as file-scope compile-time constants
(A-LeGO-LOAM ``include/alego/utility.h:50-81``) plus magic numbers at point
of use (leaf sizes ``LM.cpp:171-175``, loop params ``LM.cpp:210-213``, keyframe
distance ``LM.cpp:177``).  Here every knob lives in one frozen dataclass that is
hashable, so it can be closed over as a jit-static constant; the default values
reproduce the reference's standalone (``IP``/``LO``/``LM``) variant.

Capacities (``max_*``) have no reference counterpart: the reference uses
dynamically sized ``pcl::PointCloud`` containers, while every array here has a
static shape so the whole pipeline stays inside one XLA program.  Values were
chosen from the reference's telemetry (segmented cloud ≲ 64k = 16x4000;
feature picks ≤ 2/20/4 per sector x 96 sectors).
"""

from __future__ import annotations

import dataclasses
import enum
import math


class LaserType(enum.IntEnum):
    """Sensor models supported by the reference (utility.h:75-81)."""

    LSLIDAR_C16 = 0
    RFANS_16M = 1


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    # --- sensor geometry (utility.h:50-58) ---
    n_scan: int = 16                # vertical beams
    horizon_scan: int = 4000        # columns: 360 / ang_res_x
    ang_res_x_deg: float = 0.09     # horizontal resolution (5 Hz spin)
    ang_res_y_deg: float = 2.0      # nominal vertical resolution
    scan_period: float = 0.2        # seconds per sweep (5 Hz)
    ang_bottom_deg: float = 15.0    # lowest beam elevation magnitude
    ground_scan_id: int = 10        # bottom rings eligible for ground
    sensor_mount_ang_deg: float = 0.0
    laser_type: LaserType = LaserType.RFANS_16M

    # --- projection / segmentation (utility.h:60-65, IP.cpp) ---
    min_range: float = 1.0          # removeClosedPointCloud threshold (IP.cpp:117)
    seg_theta: float = 1.047        # angle criterion (utility.h:63)
    seg_valid_point_num: int = 5    # utility.h:64
    seg_valid_line_num: int = 3     # utility.h:65
    seg_big_cluster: int = 30       # IP.cpp:379
    ground_angle_thresh_deg: float = 10.0  # IP.cpp:223
    ground_subsample: int = 5       # keep every 5th ground column (IP.cpp:273)
    outlier_subsample: int = 5      # keep every 5th outlier (IP.cpp:265)

    # --- feature extraction (LO.cpp:191-365) ---
    edge_curv_thresh: float = 0.1   # curvature split sharp/flat (LO.cpp:263,313)
    n_sectors: int = 6              # sectors per ring (LO.cpp:246)
    max_sharp_per_sector: int = 2   # LO.cpp:267
    max_less_sharp_per_sector: int = 20  # LO.cpp:273
    max_flat_per_sector: int = 4    # LO.cpp:319
    suppress_neighbors: int = 5     # LO.cpp:282-305
    suppress_col_gap: int = 10      # LO.cpp:285
    # True: pick in all 6 sectors simultaneously (6x fewer sequential steps;
    # deviates from the reference's strict left-to-right sector order only
    # when picks land within 5 columns of a sector boundary). False: exact
    # sequential semantics.
    parallel_sectors: bool = True
    occl_depth_jump: float = 0.5    # LO.cpp:209,216
    occl_col_gap: int = 10          # LO.cpp:206
    parallel_rel_diff: float = 0.02 # LO.cpp:224
    less_flat_leaf: float = 0.4     # LO.cpp:361

    # --- scan-to-scan odometry (LO.cpp:398-583) ---
    nearest_feature_dist_sq: float = 25.0  # utility.h:73
    ring_search_span: float = 2.5   # +-2.5 rings for 2nd/3rd points (LO.cpp:421,445)
    odom_surf_iters: int = 5        # ceres max_num_iterations (LO.cpp:486)
    odom_corner_iters: int = 5      # LO.cpp:564
    odom_outer_iters: int = 3       # re-associate + re-solve passes.  The
                                    # reference associates ONCE per step at
                                    # the warm start (LO.cpp:408,498) — fine
                                    # for its slow platform, but at yaw-rate
                                    # TRANSITIONS (corner entry/exit) the
                                    # warm start is off by the full rate
                                    # step and the single association locks
                                    # in a ~1.5-3 deg error per transition
                                    # (measured: corner-concentrated drift
                                    # on the urban validation circuit).
                                    # Re-association passes at the converged
                                    # pose remove it for ~0.2 ms each;
                                    # measured on the urban validation
                                    # circuit (IMU de-skew on): ATE 11.8 /
                                    # 7.8 / 6.7 m at 1 / 2 / 3 passes, and
                                    # corner yaw bias -6.3 deg -> +0.5 deg
                                    # on the static fast-turn scene.
    min_correspondences: int = 10   # LO.cpp:481,555
    huber_delta: float = 0.1        # HuberLoss(0.1) (LO.cpp:402, LM.cpp:508)
    odom_eig_floor: float = 0.0     # LOAM isDegenerate floor for the odometry
                                    # solves (0 = off); see odom_prior_weight
    odom_dense_corners: bool = False  # query ALL less-sharp corners (~1k) in
                                    # the odometry corner step instead of the
                                    # reference's 2-per-sector sharp set
                                    # (LO.cpp:498) — a TPU-first deviation:
                                    # batching is free, ~10x the constraints
                                    # cut the weak-direction increment noise
    odom_prior_weight: float = 0.0  # Tikhonov prior toward the constant-
                                    # velocity warm start in the odometry
                                    # solves.  Measured (benchmarks/
                                    # seed2_spectrum.py): on weak-geometry
                                    # stretches the along-track eigenvalue of
                                    # the corner (x,y,yaw) Hessian dips to
                                    # ~4-15 while yaw sits at ~1e4 — the weak
                                    # direction then follows per-frame noise
                                    # as a velocity random walk (the 2.69 m
                                    # seed-2 tail).  A prior ~ the weak-dip
                                    # scale regularises exactly those dims.
    # ROUND-4 A/B DECISION (benchmarks/error_budget_ab.json, 3 sensor-sim
    # seeds, no-loop ATE): after the de-skew data-path fixes (IMU ring +
    # yaw-wrap blend) removed the drift these knobs were built against,
    # none beats the baseline beyond chaos (baseline 2.14 median / 2.30
    # worst; floor5 2.01/2.11; prior5 2.02/2.24) and odom_dense_corners
    # actively hurts on urban scenes (3.71/3.78 — the extra corners are
    # low-curvature facade points that dilute the sharp set).  All three
    # therefore SHIP OFF; re-run the A/B before enabling on a new sensor.

    # --- scan-to-map (LM.cpp) ---
    map_frame_decimation: int = 2   # every 2nd frame (LM.cpp:244-245)
    corner_leaf: float = 0.4        # ds_corner_ (LM.cpp:171)
    surf_leaf: float = 0.8          # ds_surf_ (LM.cpp:172)
    outlier_leaf: float = 1.0       # ds_outlier_ (LM.cpp:173)
    keypose_leaf: float = 1.0       # ds_keyposes_ (LM.cpp:174)
    history_leaf: float = 0.4       # ds_history_keyframes_ (LM.cpp:175)
    recent_keyframe_search_num: int = 50   # LM.cpp:182
    surround_keyframe_search_radius: float = 50.0  # LM.cpp:183
    map_outer_iters: int = 2        # LM.cpp:505
    map_gn_iters: int = 20          # LM.cpp:615
    map_gn_tol: float = 1e-4        # mapping GN early-stop; 3e-4 measured
                                    # a 30% ATE cost for no fps gain
    map_knn: int = 5                # 5-NN association (LM.cpp:520,568)
    map_nn_max_dist_sq: float = 1.0  # point_dist_[4] < 1.0 (LM.cpp:521,571)
    line_eig_ratio: float = 3.0     # lambda2 > 3*lambda1 (LM.cpp:548)
    plane_fit_tol: float = 0.2      # LM.cpp:591
    min_corner_for_map: int = 10    # LM.cpp:495
    min_surf_for_map: int = 100     # LM.cpp:495
    map_eig_floor: float = 1.0      # LOAM isDegenerate eigen floor on the
                                    # scan-to-map H: directions of H with
                                    # eigenvalue below this are unobservable
                                    # (sparse first-frame maps, corridors) and
                                    # their update is projected out — upstream
                                    # LeGO-LOAM uses 100 at ~10x our typical
                                    # constraint counts; the reference relies
                                    # on Ceres's trust region instead.
                                    # Value measured (2026-08) on the two
                                    # tiny-config scenes whose ~10-30-
                                    # constraint first frames pull the floor
                                    # in opposite directions (3-seed median
                                    # ATE, scene31/scene32):
                                    #   floor=0    0.92 / 0.13
                                    #   floor=1    0.19 / 0.11  <- default
                                    #   floor=10   0.14 / 0.51
                                    #   Ceres-LM   1.15 / 0.23  (see
                                    #   gauss_newton.py negative result)
                                    # Genuinely degenerate dims sit at ridge
                                    # level (<<1); legitimate weak dims of
                                    # small solves reach ~1-10, so 10 froze
                                    # real directions.  Full-config
                                    # steady-state spectra sit well above 10
                                    # either way.
    min_keyframe_dist_sq: float = 1.0  # squared-vs-metre quirk (LM.cpp:646-649)

    # --- loop closure (LM.cpp:206-213, 800-975) ---
    loop_closure_enabled: bool = True
    history_search_radius: float = 10.0   # LM.cpp:210
    history_search_num: int = 25          # LM.cpp:211
    history_fitness_score: float = 0.3    # LM.cpp:212
    loop_time_gap: float = 30.0           # LM.cpp:934
    loop_every_n_frames: int = 5          # attempt cadence in INPUT FRAMES:
                                          # 5 frames x 0.2 s = the reference's
                                          # 1 Hz loop thread (LM.cpp:785).
                                          # Time-driven, not keyframe-parity —
                                          # a stalled keyframe count can never
                                          # starve loop attempts
    icp_max_corr_dist: float = 100.0      # LM.cpp:819
    icp_iters: int = 100                  # LM.cpp:820
    icp_translation_eps: float = 1e-6     # LM.cpp:821

    # Drift-aware candidate search (TPU-first deviation; no ref counterpart).
    # The reference searches keyposes at a FIXED 10 m radius (LM.cpp:210,927)
    # — but the whole point of loop closure is rescuing accumulated drift,
    # which grows with path length; at 2-3% odometry drift a 300 m revisit
    # arrives ~9 m off and sits at the fixed radius's edge.  The effective
    # radius grows with the chain path length between candidate and latest:
    #     r_eff(i) = history_search_radius + frac * path(i -> latest)
    loop_drift_radius_frac: float = 0.05

    # Coarse loop alignment (ops/bev_align): when the identity-initialised
    # ICP (the reference's LM.cpp:828-836 behaviour) fails the gate, a
    # bird's-eye structure-grid correlation recovers (yaw, dx, dy, dz)
    # globally — basin ~ +-half the grid vs ICP's couple of metres — and one
    # full ICP refines from it.  Replaces the round-3 yaw-only multi-start
    # (which fixed rotation basins but not the 9 m translation drift the
    # validation circuit showed).  False by the reference's book, on for
    # production: without it loop closure demonstrably never fires under
    # realistic revisit drift (benchmarks/validation_run.json r3).
    loop_coarse_align: bool = True
    loop_in_step: bool = True             # compile the loop-closure attempt
                                          # INTO slam_step/scan (bench mode:
                                          # every cost inside one program).
                                          # False = the host driver runs the
                                          # attempt as its own jitted program
                                          # between dispatches (the
                                          # reference's separate 1 Hz thread,
                                          # LM.cpp:779); the scan program
                                          # then compiles in ~96 s instead of
                                          # 156-1219 s (contended v5e) and
                                          # the loop program compiles lazily
                                          # on the first eligible attempt.
                                          # CLI --bag/--input default to the
                                          # hoisted mode when chunked.
    loop_icp_decimate: int = 2            # loop ICP iterates on src[::d]
                                          # (acceptance scores the full
                                          # cloud); 1 = off
    loop_rescue_icp_iters: int = 30       # refine budget after the BEV
                                          # coarse align (near-basin start;
                                          # the identity attempt keeps the
                                          # full icp_iters budget)
    loop_bev_grid: int = 96               # cells; extent = grid * res
    loop_bev_res: float = 1.0             # m / cell
    loop_bev_yaws: int = 36               # 10 deg steps; ICP absorbs the rest

    # Density-normalised acceptance (replaces the raw mean-squared-NN gate
    # when loop_min_inlier_frac > 0).  The reference accepts on
    # getFitnessScore() < 0.3 (LM.cpp:842) — a RAW mean over all source
    # points, whose value scales with point density AND collapses under
    # partial overlap (non-overlapping far points dominate the mean: the
    # round-3 validation attempts bottomed at 1.4 with visually plausible
    # alignments).  Normalised gate, computed over STRUCTURE points (>0.4 m
    # above the cloud's own ground — ground matches anywhere and would
    # inflate the score): a fraction >= loop_min_inlier_frac must find a
    # neighbour within loop_inlier_radius and their RMS must beat
    # loop_inlier_rmse.  Calibration (laser_mapping._loop_acceptance):
    # correct alignments measure frac ~0.8-0.9 / RMS ~0.35; 3 m-misaligned
    # ones ~0.2-0.3 / ~0.65; a single-wall symmetry ALIAS (one of two walls
    # matches perfectly, the other not at all) measures ~0.57 — the gate
    # must sit above the one-major-surface alias band.  Set
    # loop_min_inlier_frac = 0 for reference behaviour (the raw gate).
    loop_min_inlier_frac: float = 0.70
    loop_inlier_radius: float = 1.0       # m
    loop_inlier_rmse: float = 0.5         # m RMS over structure inliers

    # Consistency gates (no ref counterpart): a loop correction larger than
    # the plausible accumulated drift is a false match by construction.
    #   |t_correction| <= abs + frac * path(closest -> latest)
    # After the pose-graph solve, the recent chain must not bend beyond
    # loop_chain_bend_max per link (translation) or the factor is rolled
    # back.  Zero disables a gate.
    loop_max_correction_abs: float = 2.0
    loop_max_correction_frac: float = 0.15
    loop_chain_bend_max: float = 1.0      # m per chain link post-solve
    loop_chain_bend_max_rot_deg: float = 6.0  # deg per link post-solve (the
                                          # chain absorbs endpoint corrections
                                          # mostly via per-link yaw — the
                                          # lever arm — so rotation is the
                                          # binding check)

    # --- pose graph (LM.cpp:197-204) ---
    # The reference's gtsam variances (1e-6 rot / 1e-8..1e-6 trans,
    # LM.cpp:201-204) give a chain:loop stiffness ratio ~1e6 that is both
    # numerically hostile in f32 and makes loop factors nearly inert; we keep
    # the chain much stiffer than loops but at a conditioning-safe ratio.
    # Order: twist [rho(3), phi(3)] variances.
    pose_graph_chain_sigma: tuple = (1e-4, 1e-4, 1e-4, 1e-4, 1e-4, 1e-4)
    pose_graph_gn_iters: int = 3   # GN converges in 2-3 (tests); each iter
                                   # is one O(N) factored chain solve

    # --- base-link extrinsic (LO.cpp:591-608) ---
    # (x, y, z, roll, pitch, yaw) of the LASER frame expressed in BASE-LINK:
    # the reference's launch-param tf_b2l_, applied as
    # T_odom2base = T_odom2laser @ T_b2l^-1 when publishing (LO.cpp:591).
    # SLAM runs in the laser frame; reported trajectory poses are base-link.
    tf_b2l: tuple = (0.0, 0.0, 0.0, 0.0, 0.0, 0.0)

    # --- IMU / odom (utility.h:68-70, LO.cpp:737-881) ---
    use_imu: bool = False           # de-skew call is disabled in ref (LO.cpp:184)
    use_odom: bool = False          # external-odometry aid (utility.h:69):
                                    # same de-skew path, samples fed via
                                    # SlamPipeline.add_odom
    imu_queue_length: int = 200

    # --- static capacities (new: required for fixed XLA shapes) ---
    max_raw_points: int = 65536     # raw scan capacity (<=16x4000)
    ring_width: int = 2048          # compacted points per ring
    max_sharp: int = 256            # 2 x 6 x 16 = 192 rounded up
    max_less_sharp: int = 2048      # 20 x 6 x 16 = 1920 rounded up
    max_flat: int = 512             # 4 x 6 x 16 = 384 rounded up
    max_less_flat: int = 8192       # less-flat after 0.4 voxel filter
    max_outlier: int = 4096         # subsampled outliers
    max_keyframes: int = 2048       # pose-graph capacity (~2 km at the 1 m
                                    # gate); overflowing keyframes are
                                    # rejected + counted (pose_graph.overflow)
    kf_corner_cap: int = 1024       # per-keyframe stored corner points
    kf_surf_cap: int = 2048         # per-keyframe stored surf points
    kf_outlier_cap: int = 1024      # per-keyframe stored outlier points
    map_corner_cap: int = 8192      # merged+downsampled local corner map
    map_surf_cap: int = 16384       # merged+downsampled local surf map
    loop_hist_cap: int = 32768      # loop-closure history cloud
    loop_latest_cap: int = 4096     # loop-closure latest keyframe cloud
    max_loop_factors: int = 32      # stored loop-closure constraints.
                                    # Width of the Woodbury fold-in
                                    # (K = 1 + 6L rhs columns through the
                                    # chain solve) scales compile + runtime;
                                    # 32 is >3x any measured closure count
                                    # (bench: <=9) and overflow is counted,
                                    # never silent (pose_graph)
    knn_chunk: int = 4096           # map points per streamed KNN chunk

    compute_dtype: str = "float32"

    # ---- derived helpers (not fields) ----
    @property
    def ang_res_x(self) -> float:
        return math.radians(self.ang_res_x_deg)

    @property
    def ang_res_y(self) -> float:
        return math.radians(self.ang_res_y_deg)

    @property
    def ang_bottom(self) -> float:
        return math.radians(self.ang_bottom_deg)

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


# Small geometry for fast tests: 16 x 900 image at 0.4 deg.
def tiny_config(**kw) -> PipelineConfig:
    base = dict(
        horizon_scan=900,
        ang_res_x_deg=0.4,
        max_raw_points=16384,
        ring_width=512,
        max_less_flat=4096,
        max_outlier=1024,
        max_keyframes=64,
        kf_corner_cap=512,
        kf_surf_cap=1024,
        kf_outlier_cap=512,
        map_corner_cap=4096,
        map_surf_cap=8192,
        loop_hist_cap=12288,
        loop_latest_cap=2048,
        max_loop_factors=16,
        knn_chunk=1024,
    )
    base.update(kw)
    return PipelineConfig(**base)


DEFAULT_CONFIG = PipelineConfig()
