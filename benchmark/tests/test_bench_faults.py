"""Runs with the timed path broken underneath: the judge has to see each
fault a cell can have (a step that returns its state unchanged, half of
the batch left out, an answer altered where it is produced) and
``correct`` has to come out false. The cells run tiny on the CPU through
the plain route; the harness's look for a card is skipped."""

import dataclasses

import pytest
import torch

from conftest import dry_run


def _row(res, name):
    return {n: (v, lim) for n, v, lim, _ in res["check"].rows}[name]


# --------------------------------------------------------------- front end

def _orb_fault(kind):
    from kornia_tpu_torch.features import orb
    real = orb.orb_detect_and_describe
    first = {}

    def broken(*a, **kw):
        f = real(*a, **kw)
        if kind == "unchanged":         # every frame gets the first's state
            return first.setdefault("f", f)
        d = f.descriptors.clone()
        if kind == "half":              # half the keypoints never described
            d[d.shape[0] // 2:] = 0
        else:                           # each descriptor's first bit flipped
            d[:, 0] ^= 1
        return f._replace(descriptors=d)

    return orb, "orb_detect_and_describe", broken


def _match_fault():
    from kornia_tpu_torch.features import matching
    real = matching.match_descriptors

    def broken(*a, **kw):
        m = real(*a, **kw)
        return m._replace(idx=torch.where(m.mask, m.idx + 1, m.idx))

    return matching, "match_descriptors", broken


@pytest.mark.parametrize("kind,number", [
    ("unchanged", "orb_miss"), ("half", "orb_miss"), ("altered", "orb_miss"),
    ("match", "match_miss")])
def test_front_end_faults_are_caught(monkeypatch, kind, number):
    mod, name, fn = _match_fault() if kind == "match" else _orb_fault(kind)
    monkeypatch.setattr(mod, name, fn)
    res, line = dry_run("orb_kitti.stream", 4.0)
    value, limit = _row(res, number)
    assert value > limit and line["correct"] is False


# --------------------------------------------------- the SLAM loop (held out)

def _ba_fault(kind):
    from kornia_tpu_torch.optim import ba
    real = ba.bundle_adjust_schur

    def broken(problem, params, *a, **kw):
        if kind == "unchanged":         # the solve returns its start
            return real(problem, dataclasses.replace(params,
                                                     max_iterations=0))
        w = problem.obs_w.clone()
        w[1::2] = 0.0                   # every other observation left out
        return real(problem._replace(obs_w=w), params, *a, **kw)

    return ba, "bundle_adjust_schur", broken


def _track_fault():
    from kornia_tpu_torch.slam import system
    real = system.track_step

    def broken(*a, **kw):
        out = real(*a, **kw)
        t = out.pose.translation + 0.05  # the pose altered where produced
        return out._replace(pose=out.pose._replace(translation=t))

    return system, "track_step", broken


@pytest.mark.parametrize("kind,number", [
    ("unchanged", "local_ba_gap"), ("half", "local_ba_gap"),
    ("track", "track_gap")])
def test_slam_loop_faults_are_caught(monkeypatch, kind, number):
    mod, name, fn = _track_fault() if kind == "track" else _ba_fault(kind)
    monkeypatch.setattr(mod, name, fn)
    res, _ = dry_run("slam_euroc.loop", 8.0, seed=0)
    value, limit = _row(res, number)
    assert value > limit and res["check"].correct is False
