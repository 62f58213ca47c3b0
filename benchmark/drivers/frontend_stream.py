"""Driver "frontend_stream": the ORB front end of visual odometry on a
stream of frames, back to back (a closed loop with one client).

Per frame, as ``kornia_tpu_torch.examples.orb_tracking_live`` runs it:
the host u8 frame uploaded and described by
``features.orb.orb_detect_and_describe`` with the configuration's
``OrbConfig``, matched against the previous frame's features by
``features.matching.match_descriptors`` (cross-check on, the defaults
otherwise), and the match count read back. The traffic's frames are
replayed cyclically; set-up runs one whole cycle, so the first timed
frame's predecessor is the cycle's last.

A reservoir sample of the window's frames, drawn from the seed, keeps its
features and matches; once the window has closed they are judged against
the plain reference (benchmark/reference/orb.py).
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import harness, roofline
from benchmark.reference import orb as ref_orb


def run(ctx) -> dict:
    from kornia_tpu_torch.features import matching, orb

    config, traffic, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    parts = {"start_s": ctx.t_driver - ctx.t_process,
             "port_import_s": time.time() - ctx.t_driver}
    t = time.perf_counter()
    data = harness.load_module("traffic", traffic["generator"]).generate(
        ctx.seed, config, traffic)
    frames = data["frames"]
    n = len(frames)
    parts["frames_s"] = time.perf_counter() - t
    ocfg = orb.OrbConfig(**config["orb"])
    spans = harness.Spans(ctx.trace)
    detect = spans.wrap("orb", lambda f: orb.orb_detect_and_describe(
        f, ocfg, device=dev))
    match = spans.wrap("match", lambda a, b: matching.match_descriptors(
        a.descriptors, b.descriptors, a_mask=a.mask, b_mask=b.mask,
        cross_check=True, device=dev))
    count = spans.wrap("readback", lambda m: int(m.mask.sum()))

    def step(prev, f):
        feats = detect(f)
        m = match(prev, feats)
        return feats, m, count(m)

    t = time.perf_counter()
    prev = detect(frames[0])
    for f in frames[1:]:
        prev, _, _ = step(prev, f)
    ctx.sync()
    parts["warmup_s"] = time.perf_counter() - t
    spans.rows.clear()
    setup_s = time.time() - ctx.t_process

    traced = ctx.traced()
    kept, offer = harness.reservoir(np.random.default_rng([ctx.seed, 29]),
                                    config["sample"]["frames"])
    ms, kps = [], []
    t_w0 = time.perf_counter()
    deadline = t_w0 + ctx.seconds
    i = 0
    while True:
        f = frames[i % n]
        spans.tag = i
        t0 = time.perf_counter()
        if traced is not None:
            feats, m, _ = traced.call(lambda p=prev, f=f: step(p, f))
        else:
            feats, m, _ = step(prev, f)
        t1 = time.perf_counter()
        ms.append((t1 - t0) * 1e3)
        offer(i, lambda: (i % n, feats, m.idx))
        if traced is not None:
            kps.append(int(feats.mask.sum()))
        prev = feats
        i += 1
        if t1 >= deadline:
            break
    window_s = time.perf_counter() - t_w0
    memory = ctx.memory_peak()
    del prev, feats, m
    ctx.free()

    out = {"attempted": len(ms), "failed": 0, "setup_s": setup_s,
           "setup_parts": parts, "memory_peak_bytes": memory,
           "e2e": {"frontend_frames_per_s": len(ms) / window_s,
                   "frontend_frame_ms_p95": harness.percentile(ms, 95)},
           "window_s": window_s, "frame_ms": ms}
    t = time.perf_counter()
    out["check"], out["control"] = judge(ctx, kept, frames)
    out["judge_s"] = time.perf_counter() - t
    out["record"] = {"spans": spans, "traced": traced,
                     "program": [] if traced is None else traced.rows,
                     "frame_ms": ms, "card": ctx.card,
                     "orb_work": [roofline.orb_work(
                         frames[0].shape, ocfg.n_levels, ocfg.scale_factor,
                         k) for k in kps]}
    return out


def _features_miss(ref, xy, desc, mask) -> float:
    """Share of the reference's keypoint slots that the candidate gets
    wrong: validity, position (1e-3 px) or descriptor bits."""
    rm = ref.mask.cpu().numpy()
    bad = rm != mask
    both = rm & mask
    bad |= both & np.any(np.abs(ref.xy.cpu().numpy() - xy) > 1e-3, 1)
    bad |= both & np.any(ref.descriptors.cpu().numpy() != desc, 1)
    return float(bad.sum()) / max(int(rm.sum()), 1)


def _match_miss(ref_idx, idx) -> float:
    return float(np.sum(ref_idx != idx)) / max(int(np.sum(ref_idx >= 0)), 1)


def judge(ctx, kept, frames):
    import torch

    config = ctx.cell.config
    lim = config["limits"]
    dev = ctx.device
    low = getattr(torch, config["control_dtype"])
    n = len(frames)
    keys = ["program"] + (["control"] if ctx.control else [])
    checks = {key: harness.Check() for key in keys}
    cache = {}

    def ref(i, ftype):
        if (i, ftype) not in cache:
            cache[(i, ftype)] = ref_orb.orb(frames[i], config["orb"], dev,
                                            ftype)
        return cache[(i, ftype)]

    miss = {key: 0.0 for key in keys}
    mmiss = {key: 0.0 for key in keys}
    for it in sorted(kept):
        i, feats, idx = kept[it]
        p = (i - 1) % n
        r_cur, r_prev = ref(i, torch.float32), ref(p, torch.float32)
        r_idx = ref_orb.match(r_prev.descriptors, r_cur.descriptors,
                              r_prev.mask, r_cur.mask).cpu().numpy()
        cands = {"program": (feats.xy.cpu().numpy(),
                             feats.descriptors.cpu().numpy(),
                             feats.mask.cpu().numpy(),
                             idx.cpu().numpy().astype(np.int64))}
        if ctx.control:
            c_cur, c_prev = ref(i, low), ref(p, low)
            cands["control"] = (
                c_cur.xy.cpu().numpy(), c_cur.descriptors.cpu().numpy(),
                c_cur.mask.cpu().numpy(),
                ref_orb.match(c_prev.descriptors, c_cur.descriptors,
                              c_prev.mask, c_cur.mask,
                              ftype=low).cpu().numpy())
        for key, (xy, desc, mask, midx) in cands.items():
            miss[key] = max(miss[key], _features_miss(r_cur, xy, desc, mask))
            mmiss[key] = max(mmiss[key], _match_miss(r_idx, midx))
    for key in keys:
        checks[key].at_most("orb_miss", miss[key], lim["orb_miss"])
        checks[key].at_most("match_miss", mmiss[key], lim["match_miss"])
        checks[key].at_least("frames_judged", len(kept),
                             config["sample"]["frames"])
    return checks["program"], checks.get("control")
