"""Driver "slam_loop": sessions of the monocular SLAM frame loop,
``kornia_tpu_torch.slam.MonocularSlam.process_frame``, frames back to back
(a closed loop with one client, as offline processing of a recorded
sequence).

Set-up: the frames (the workload's traffic generator), the vocabulary (the
port's ``Vocabulary.build`` from the port's ORB of every
``vocabulary.every``-th frame), then one whole session as warm-up. The
window: fresh ``MonocularSlam`` sessions on the same frames and vocabulary,
each frame timed from the call (host u8 frame in) to its synchronised end,
until ``seconds`` have passed. The session the window closed in then runs
its remaining frames untimed and untraced, so that every session is judged
whole: the configuration's trajectory guarantee is that of the whole loop,
and a session cut on its outbound half has not yet closed a loop, so its
drift, and with it whether the run reads correct, would depend on where
the window happened to end.

What the window produced is captured by wrapping the port's functions by
name (their inputs and outputs are kept, nothing is copied in the window):
``_extract`` (ORB), ``track_step`` (the tracking step) with the problem
its polish ``pnp.refine_pose_reprojection`` solved (RANSAC's inliers),
``ba.bundle_adjust_schur`` (local BA, and global BA at a closure),
``pgo.pose_graph_optimize`` (PGO at a closure). Once the window has
closed, a sample drawn from the seed is judged against the plain reference
(benchmark/reference); the trajectory of every session against the ground
truth.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import harness, roofline
from benchmark.reference import orb as ref_orb
from benchmark.reference import solve as ref

STAGES = ("_extract", "_initialize", "_track", "_insert_keyframe",
          "_triangulate_new", "_local_ba", "_try_loop_closure", "_run_pgo",
          "global_ba")


def frame_kinds(results):
    """Each frame's kind: bootstrap (the frames up to and including the
    one that initialises), loop closure, keyframe, or tracked (the rest,
    lost frames too). Frozen copy of chip_smoke.frame_kinds at adb6c1a."""
    kinds, booting = [], True
    for r in results:
        if booting:
            kinds.append("bootstrap")
            booting = r.state.value == "initializing"
        elif r.loop_closed_with is not None:
            kinds.append("loop closure")
        elif r.is_keyframe:
            kinds.append("keyframe")
        else:
            kinds.append("tracked")
    return kinds


class Capture:
    """Keeps what the program's stages took and gave during the window."""

    def __init__(self, slam_sys, pnp_mod, ba_mod, pgo_mod):
        self.on = False
        self.system = None
        self.kind = "local"
        self.polish = None
        self.extract, self.track, self.ba, self.pgo = [], [], [], []
        self._restore = [(slam_sys, "track_step", slam_sys.track_step),
                         (pnp_mod, "refine_pose_reprojection",
                          pnp_mod.refine_pose_reprojection),
                         (ba_mod, "bundle_adjust_schur",
                          ba_mod.bundle_adjust_schur),
                         (pgo_mod, "pose_graph_optimize",
                          pgo_mod.pose_graph_optimize)]
        step, polish, bas, pgo = (f for _, _, f in self._restore)

        def track_step(*a, **kw):
            prev = self.system._last_pose.copy()
            self.polish = None
            out = step(*a, **kw)
            if self.on:
                self.track.append((prev, self.polish, out))
            return out

        def refine_pose_reprojection(r, t, world, pixels, k, inliers, *a,
                                     **kw):
            self.polish = (world, pixels, inliers)
            return polish(r, t, world, pixels, k, inliers, *a, **kw)

        def bundle_adjust_schur(problem, params, *a, **kw):
            out = bas(problem, params, *a, **kw)
            if self.on:
                self.ba.append((self.kind, problem, params, out))
            return out

        def pose_graph_optimize(poses, ei, ej, meas, *a, **kw):
            out = pgo(poses, ei, ej, meas, *a, **kw)
            if self.on:
                w = a[0] if a else kw["edge_weight"]
                self.pgo.append((poses, ei, ej, meas, w, kw["fixed"],
                                 kw["params"], out))
            return out

        slam_sys.track_step = track_step
        pnp_mod.refine_pose_reprojection = refine_pose_reprojection
        ba_mod.bundle_adjust_schur = bundle_adjust_schur
        pgo_mod.pose_graph_optimize = pose_graph_optimize

    def attach(self, system):
        """Wrap one session's stage methods."""
        self.system = system
        extract, local, glob = (system._extract, system._local_ba,
                                system.global_ba)

        def _extract(gray):
            xy, desc = extract(gray)
            if self.on:   # the index in the sequence of the frame extracted
                self.extract.append((system._frame_idx + 1, xy, desc))
            return xy, desc

        def _local_ba():
            self.kind = "local"
            return local()

        def global_ba(*a, **kw):
            self.kind = "global"
            try:
                return glob(*a, **kw)
            finally:
                self.kind = "local"

        system._extract, system._local_ba, system.global_ba = (
            _extract, _local_ba, global_ba)

    def close(self):
        for mod, name, fn in self._restore:
            setattr(mod, name, fn)


def _slam_config(slam_sys, config: dict, seed: int):
    return slam_sys.SlamConfig(**config["slam"], **config["assumed"]["slam"],
                               seed=seed % (2 ** 63))


def run(ctx) -> dict:
    from kornia_tpu_torch.bow import Vocabulary
    from kornia_tpu_torch.features import orb
    from kornia_tpu_torch.geometry import pnp as pnp_mod
    from kornia_tpu_torch.optim import ba as ba_mod
    from kornia_tpu_torch.optim import pgo as pgo_mod
    from kornia_tpu_torch.slam import system as slam_sys

    config, traffic, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    parts = {"start_s": ctx.t_driver - ctx.t_process,
             "port_import_s": time.time() - ctx.t_driver}
    t = time.perf_counter()
    data = harness.load_module("traffic", traffic["generator"]).generate(
        ctx.seed, config, traffic)
    frames, k = data["frames"], data["k"]
    parts["frames_s"] = time.perf_counter() - t

    t = time.perf_counter()
    voc = config["vocabulary"]
    ocfg = orb.OrbConfig(n_features=config["slam"]["n_features"],
                         n_levels=config["slam"]["n_levels"])
    descs = []
    for f in frames[::voc["every"]]:
        feats = orb.orb_detect_and_describe(f, ocfg, device=dev)
        descs.append(slam_sys._pack(feats.descriptors[feats.mask]).cpu()
                     .numpy())
    vocab = Vocabulary.build(np.concatenate(descs), k=voc["k"],
                             depth=voc["depth"], seed=voc["seed"], device=dev)
    parts["vocabulary_s"] = time.perf_counter() - t

    scfg = _slam_config(slam_sys, config, ctx.seed)
    cap = Capture(slam_sys, pnp_mod, ba_mod, pgo_mod)
    spans = harness.Spans(ctx.trace)

    def session():
        system = slam_sys.MonocularSlam(k, scfg, vocabulary=vocab, device=dev)
        cap.attach(system)
        for name in STAGES:
            tag = ((lambda r: r is not None) if name == "_try_loop_closure"
                   else None)
            setattr(system, name, spans.wrap(name, getattr(system, name),
                                              tag))
        return system

    try:
        t = time.perf_counter()
        warm = session()
        for f in frames:
            warm.process_frame(f)
        ctx.sync()
        parts["warmup_s"] = time.perf_counter() - t
        del warm
        spans.rows.clear()
        setup_s = time.time() - ctx.t_process

        traced = ctx.traced()
        ms, sessions = [], []
        cap.on = True
        t_w0 = time.perf_counter()
        deadline = t_w0 + ctx.seconds
        done = False
        while not done:
            system = session()
            sessions.append(system)
            for f in frames:
                spans.tag = len(ms)     # the frame's index in the window
                t0 = time.perf_counter()
                if traced is not None:
                    traced.call(lambda f=f: system.process_frame(f))
                else:
                    system.process_frame(f)
                    ctx.sync()
                t1 = time.perf_counter()
                ms.append((t1 - t0) * 1e3)
                if t1 >= deadline:
                    done = True
                    break
        window_s = time.perf_counter() - t_w0
        cap.on = False
        n_rows = len(spans.rows)
        for f in frames[len(system.results):]:
            system.process_frame(f)
        ctx.sync()
        del spans.rows[n_rows:]
    finally:
        cap.close()

    memory = ctx.memory_peak()
    kinds = []
    runs = []
    for system in sessions:
        kinds.extend(frame_kinds(system.results))
        runs.append({"results": [(r.pose is not None, r.loop_closed_with)
                                 for r in system.results],
                     "poses": [kf.pose.copy() for kf in system.map.keyframes],
                     "frames": [kf.frame_idx for kf in system.map.keyframes]})
    del sessions, system
    ctx.free()

    out = {"attempted": len(ms), "failed": 0, "setup_s": setup_s,
           "setup_parts": parts, "memory_peak_bytes": memory,
           "e2e": {"slam_frames_per_s": len(ms) / window_s,
                   "slam_frame_ms_p90": harness.percentile(ms, 90)},
           "window_s": window_s, "frame_ms": ms}
    t = time.perf_counter()
    out["check"], out["control"] = judge(ctx, cap, runs, frames, data)
    out["judge_s"] = time.perf_counter() - t
    out["record"] = {"spans": spans, "traced": traced,
                     "program": [] if traced is None else traced.rows,
                     "kinds": kinds, "frame_ms": ms, "card": ctx.card,
                     "orb_work": [roofline.orb_work(
                         frames[0].shape, ocfg.n_levels, ocfg.scale_factor,
                         len(xy)) for _, xy, _ in cap.extract]}
    return out


# -------------------------------------------------------------- the judge

def _sample(rng, items, n):
    if len(items) <= n:
        return list(items)
    return [items[i] for i in sorted(rng.choice(len(items), n, replace=False))]


def _orb_miss(ref_xy, ref_desc, xy, desc) -> float:
    """Share of the reference's features that the candidate lacks: the
    difference in count, and rows whose position (1e-3 px) or packed
    descriptor differ."""
    n = min(len(ref_xy), len(xy))
    bad = abs(len(ref_xy) - len(xy))
    if n:
        bad += int(np.sum(np.any(np.abs(ref_xy[:n] - xy[:n]) > 1e-3, 1)
                          | np.any(ref_desc[:n] != desc[:n], 1)))
    return bad / max(len(ref_xy), 1)


def _ref_features(frame, orb_cfg, device, ftype):
    f = ref_orb.orb(frame, orb_cfg, device, ftype)
    m = f.mask.cpu().numpy()
    return (f.xy.cpu().numpy().astype(np.float64)[m],
            ref_orb.packbits(f.descriptors).cpu().numpy()[m])


def _np(t):
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _ba_input(problem, params, device, dtype):
    if params.loss != "huber":
        raise ValueError(f"the reference BA has Huber only, not {params.loss}")
    return ref.BAInput(_np(problem.poses), _np(problem.points), _np(problem.k),
                       _np(problem.obs_cam), _np(problem.obs_pt),
                       _np(problem.obs_uv), _np(problem.obs_w),
                       _np(problem.fixed_poses), _np(problem.fixed_points),
                       params.loss_scale, device, dtype)


def judge(ctx, cap, runs, frames, data):
    """(the check of the program's outputs, the same check of the control:
    the reference in a lower precision in the program's place, or None)."""
    import torch

    config = ctx.cell.config
    lim = config["limits"]
    samp = config["sample"]
    dev = ctx.device
    f64 = torch.float64
    low = getattr(torch, config["control_dtype"])
    rng = np.random.default_rng([ctx.seed, 17])
    checks = {"program": harness.Check()}
    if ctx.control:
        checks["control"] = harness.Check()
    orb_cfg = dict(config["orb"], n_features=config["slam"]["n_features"],
                   n_levels=config["slam"]["n_levels"])

    # ORB of timed frames
    miss = {key: 0.0 for key in checks}
    for frame_no, xy, desc in _sample(rng, cap.extract, samp["orb"]):
        frame = frames[frame_no]
        rxy, rdesc = _ref_features(frame, orb_cfg, dev, torch.float32)
        miss["program"] = max(miss["program"], _orb_miss(rxy, rdesc, xy, desc))
        if ctx.control:
            cxy, cdesc = _ref_features(frame, orb_cfg, dev, low)
            miss["control"] = max(miss["control"],
                                  _orb_miss(rxy, rdesc, cxy, cdesc))

    # the tracking step's poses, each against the optimum of the problem
    # its polish solved: the reprojection cost over RANSAC's inliers (the
    # inliers taken again from the polished pose are another problem)
    track = {key: 0.0 for key in checks}
    min_pts = config["slam"]["min_track_points"]
    tau = config["slam"]["pnp_threshold_px"]
    k = data["k"]
    steps = [s for s in cap.track if int(s[2].n_inliers) >= min_pts]
    for prev, (world, pixels, inl), out in _sample(rng, steps,
                                                    samp["track"]):
        inl = _np(inl).astype(bool)
        world, pix = _np(world)[inl], _np(pixels)[inl]
        r0, t0 = ref.poses_rt(prev[None], f64, dev)
        pin = ref.PoseInput(world, pix, k, tau, dev)
        rr, tr = ref.pose_solve(pin, r0[0], t0[0])
        cands = {"program": (torch.as_tensor(_np(out.pose.rotation),
                                             dtype=f64).to(dev),
                             torch.as_tensor(_np(out.pose.translation),
                                             dtype=f64).to(dev))}
        if ctx.control:
            pl = ref.PoseInput(world, pix, k, tau, dev, low)
            cr, ct = ref.pose_solve(pl, r0[0].to(low), t0[0].to(low))
            cands["control"] = (cr.to(f64), ct.to(f64))
        c_ref = ref.pose_cost(pin, rr, tr)
        for key, (r, t_) in cands.items():
            track[key] = max(track[key], (ref.pose_cost(pin, r, t_) - c_ref)
                             / max(c_ref, 1e-12))

    # the back end's solves
    gaps = {key: {"local": 0.0, "global": 0.0, "pgo": 0.0} for key in checks}
    for kind in ("local", "global"):
        solves = [s for s in cap.ba if s[0] == kind]
        for _, problem, params, out in _sample(rng, solves,
                                               samp[kind + "_ba"]):
            pb = _ba_input(problem, params, dev, f64)
            c_ref = ref.ba_cost(pb, *ref.ba_solve(
                pb, params.max_iterations, params.lambda_init))
            r, t_ = ref.poses_rt(_np(out.poses), f64, dev)
            x = torch.as_tensor(_np(out.points), dtype=f64).to(dev)
            cands = {"program": (r, t_, x)}
            if ctx.control:
                pl = _ba_input(problem, params, dev, low)
                cands["control"] = tuple(v.to(f64) for v in ref.ba_solve(
                    pl, params.max_iterations, params.lambda_init))
            for key, st in cands.items():
                gaps[key][kind] = max(gaps[key][kind], abs(
                    ref.ba_cost(pb, *st) - c_ref) / max(c_ref, 1e-12))
    for poses, ei, ej, meas, w, fixed, params, out in _sample(
            rng, cap.pgo, samp["pgo"]):
        args = (_np(poses), _np(ei), _np(ej), _np(meas), _np(w), _np(fixed))
        sched = (params.max_iterations, params.lambda_init)
        pg = ref.PGOInput(*args, dev)
        c_ref = ref.pgo_cost(pg, *ref.pgo_solve(pg, *sched))
        cands = {"program": ref.poses_rt(_np(out.poses), f64, dev)}
        if ctx.control:
            pl = ref.PGOInput(*args, dev, low)
            cands["control"] = tuple(v.to(f64)
                                     for v in ref.pgo_solve(pl, *sched))
        for key, st in cands.items():
            gaps[key]["pgo"] = max(gaps[key]["pgo"], abs(
                ref.pgo_cost(pg, *st) - c_ref) / max(c_ref, 1e-12))

    # the trajectory against the ground truth, every session (each whole)
    ate = 0.0
    for r in runs:
        if len(r["poses"]) >= 3:
            p = np.stack(r["poses"])
            rot = ref.quat_to_matrix(torch.as_tensor(p[:, :4])).numpy()
            centres = -np.einsum("nji,nj->ni", rot, p[:, 4:])
            ate = max(ate, ref.ate_rmse(centres,
                                        data["centres"][r["frames"]]))
    shares = [sum(ok for ok, _ in r["results"]) / len(r["results"])
              for r in runs]
    loops = [sum(lw is not None for _, lw in r["results"]) for r in runs]

    expect = ctx.cell.traffic["expect"]
    for key, chk in checks.items():
        chk.at_most("orb_miss", miss[key], lim["orb_miss"])
        if steps:
            chk.at_most("track_gap", track[key], lim["track_gap"])
        chk.at_most("local_ba_gap", gaps[key]["local"], lim["local_ba_gap"])
        if cap.pgo or expect.get("loops_min", 0) > 0:
            chk.at_most("global_ba_gap", gaps[key]["global"],
                        lim["global_ba_gap"])
            chk.at_most("pgo_gap", gaps[key]["pgo"], lim["pgo_gap"])
        chk.at_most("ate_m", ate, config["guarantees"]["ate_rmse_max_m"])
        chk.at_least("tracked_share", min(shares),
                     config["guarantees"]["tracked_share_min"])
        if "loops_min" in expect:
            chk.at_least("loops", min(loops), expect["loops_min"])
        if "loops_max" in expect:
            chk.at_most("loops", max(loops), expect["loops_max"])
    return checks["program"], checks.get("control")
