"""The port's example CLIs (port of the repository's ``examples/``), one
module per script with the same name, flags and printed lines; each runs
on the card unless ``--cpu`` is given:

    python -m kornia_tpu_torch.examples.fast_detector --image X [--cpu]

Every module exposes ``main(argv=None)``, which returns the figures it
printed. ``frontend_step`` holds the counterparts of the root
``__graft_entry__.py``'s two entry points. Importing this package
imports none of the examples and runs nothing."""

__all__ = [
    "fast_detector",
    "orb_detector",
    "two_view",
    "pnp_demo",
    "undistort_image",
    "preprocess_pipeline",
    "apriltag_pose",
    "icp_registration",
    "bag_of_words",
    "colmap_stats",
    "camera_capture",
    "video_player",
    "orb_tracking_live",
    "vlm_demo",
    "slam_demo",
    "frontend_step",
]
