"""The ORB work counts against a hand count at one small shape."""

import numpy as np

from benchmark import roofline


def test_circle_of_the_orientation_patch():
    yy, xx = np.mgrid[-15:16, -15:16]
    assert roofline.CIRCLE_PIXELS == int((xx * xx + yy * yy <= 225).sum())


def test_orb_work_by_hand_at_20_by_30_two_levels():
    # levels 20×30 and round(20/1.2)×round(30/1.2) = 17×25: 600 + 425 px
    w = roofline.orb_work((20, 30), 2, 1.2, keypoints=10)
    assert w["int32"] == 99 * 1025
    # Harris 76 + blur 14 a pixel, the resize 4 an output pixel of level 1,
    # each keypoint 2·709 (orientation) + 512·6 + 256 (BRIEF)
    assert w["f32"] == 90 * 1025 + 4 * 425 + 10 * (1418 + 3328)
    # the u8 frame once, 53 bytes of output a keypoint
    assert w["bytes"] == 600 + 10 * 53


def test_least_time_names_its_bound_and_knows_its_cards():
    w = {"int32": 16.7e12, "f32": 33.5e12 / 2, "bytes": 3.35e12 / 4}
    t, by = roofline.least_time(w, "NVIDIA H100 80GB HBM3")
    assert (t, by) == (1.0, "int32")
    assert roofline.least_time(w, "some other card") is None
