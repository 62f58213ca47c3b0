"""``solve_pnp_ransac`` (kornia_tpu_torch/geometry/pnp.py) against the JAX
package on the seed-made scenes of test_torch_pnp.py. RANSAC draws come from
``jax.random`` in the reference; the port is handed the reference's own
draw through ``sample_idx=``. Each reference case is a compile of a few
seconds, which is why these cases have a file of their own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kornia_tpu.geometry import pnp as jpnp

from kornia_tpu_torch.geometry import pnp as tpnp

from test_torch_pnp import K, R_GT, T, _np, _ref_draw, _rot_angle, _scene

# One intra-op thread: these tests run many small ops, and torch's pool
# of a thread per core spins against the other test processes.
torch.set_num_threads(1)


# epnp and p3p in both scorings, ap3p with MSAC; ("epnp", "msac") is the
# SLAM loop's. ap3p with MAGSAC is left out: MAGSAC scores every method's
# hypotheses with the same code, and each case is a 6-10 s compile of the
# reference.
@pytest.mark.parametrize("method,scoring", [
    ("epnp", "msac"), ("epnp", "magsac"), ("p3p", "msac"),
    ("p3p", "magsac"), ("ap3p", "msac")])
def test_solve_pnp_ransac_matches_reference(method, scoring):
    """solve_pnp_ransac (256 hypotheses, LO refits, 10 LM iterations) on
    160 points, 25% outliers, 0.5 px noise, 32 padded rows, with the
    reference's draw: R within 1e-4 rad and t within 1e-3 of the
    reference's, n_inliers within ±2, the known pose within 2e-3 rad."""
    world, px, mask = _scene(13)
    key = jax.random.PRNGKey(13)
    ref = jax.jit(lambda w, p, k, m: jpnp.solve_pnp_ransac(
        key, w, p, k, threshold_px=3.0, mask=m, method=method,
        scoring=scoring))(jnp.asarray(world), jnp.asarray(px),
                          jnp.asarray(K), jnp.asarray(mask))
    draw = _ref_draw(key, mask, 6 if method == "epnp" else 4)
    pose, inl, n_inl = tpnp.solve_pnp_ransac(
        world, px, K, threshold_px=3.0, mask=mask, method=method,
        scoring=scoring, sample_idx=T(np.asarray(draw)), device="cpu")
    assert _rot_angle(_np(pose.rotation), _np(ref[0].rotation)) <= 1e-4
    np.testing.assert_allclose(_np(pose.translation),
                               _np(ref[0].translation), atol=1e-3)
    assert abs(int(n_inl) - int(ref[2])) <= 2
    assert _rot_angle(_np(pose.rotation), R_GT) <= 2e-3
    assert not _np(inl)[~mask].any()


def test_solve_pnp_ransac_own_generator_recovers_pose():
    """The port's own torch.Generator draw: the known pose within 2e-3
    rad, every true inlier row but a few found."""
    world, px, mask = _scene(15)
    gen = torch.Generator().manual_seed(0)
    pose, inl, n_inl = tpnp.solve_pnp_ransac(world, px, K, threshold_px=3.0,
                                             mask=mask, generator=gen,
                                             device="cpu")
    assert _rot_angle(_np(pose.rotation), R_GT) <= 2e-3
    assert int(n_inl) >= 115          # 120 true inliers, 0.5 px noise
    assert int(n_inl) == int(_np(inl).sum())


def test_solve_pnp_ransac_rejects_unknown_method():
    with pytest.raises(ValueError):
        tpnp.solve_pnp_ransac(np.zeros((8, 3), np.float32),
                              np.zeros((8, 2), np.float32), K,
                              method="upnp", device="cpu")
