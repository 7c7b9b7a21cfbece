"""The port's bundle adjustment (lfr_tpu_torch.sfm.ba) against lfr_tpu.sfm.ba
on tests/test_ba.py's scenes.

Both run in float32, and the port's arithmetic differs in order (closed-form
Jacobians where JAX takes ``jacfwd``, one-hot products where JAX
scatter-adds), so exact equality is not expected.  BA's accept test
``new_cost < cost`` can be decided by float32 rounding near the optimum, so
the comparison bounds come from a control: JAX against itself on inputs
scaled by 1 + 2e-7 N(0, 1) (a few ulps) under CONTROL_SEEDS.  The port may
differ from JAX by CONTROL_FACTOR times the control's largest deviation,
plus ATOL_FLOOR: the control perturbs the inputs once, while the port rounds
differently at every step (its largest reading, on the noisy scene's
points, is 2.7 times the control).  JAX's ``run_ba`` does not return its
iteration count, so counts are not compared; the port's own results must
not depend on how often its loop reads ``done``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_ba
from lfr_tpu.sfm import ba as jax_ba
from lfr_tpu.utils import synthetic as jax_synthetic
from lfr_tpu_torch.sfm import ba

CONTROL_SEEDS = (1, 2, 3)
CONTROL_FACTOR = 4.0
ATOL_FLOOR = 1e-6


_jax_schur = jax.jit(jax_ba.schur_step, static_argnames=("n_cameras",))
_jax_jacobians = jax.jit(jax_ba._obs_jacobians)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run thousands of tiny torch ops,
    which the suite's parallel workers slow down by oversubscribing the
    cores; the thread count is restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturbed(prob, seed):
    p = copy.deepcopy(prob)
    r = np.random.default_rng(seed)
    for k in ("R", "t", "points", "obs_uv"):
        x = getattr(p, k)
        setattr(p, k, x * (1 + 2e-7 * r.standard_normal(x.shape)))
    return p


def _noisy():
    rng = np.random.default_rng(1)
    scene = jax_synthetic.random_scene(rng, num_points=60, num_cameras=3, noise_px=0.5)
    return test_ba._problem_from_scene(scene, rng, cam_noise=0.005, pt_noise=0.01, fix=(0, 1)), 30


def _reduces():
    rng = np.random.default_rng(0)
    scene = jax_synthetic.random_scene(rng, num_points=80, num_cameras=4)
    return test_ba._problem_from_scene(scene, rng, fix=(0, 1)), 40


def _focal():
    rng = np.random.default_rng(3)
    scene = jax_synthetic.random_scene(rng, num_points=80, num_cameras=4)
    prob = test_ba._problem_from_scene(scene, rng, cam_noise=0.0, pt_noise=0.0, fix=(0, 1))
    prob.obs_uv[np.isin(prob.obs_cam, [2, 3])] /= 1.03
    prob.refine_focal = True
    return prob, 40


def _shared():
    rng = np.random.default_rng(4)
    scene = jax_synthetic.random_scene(rng, num_points=80, num_cameras=5)
    prob = test_ba._problem_from_scene(scene, rng, cam_noise=0.0, pt_noise=0.0, fix=(0, 1))
    prob.obs_uv[np.isin(prob.obs_cam, [2, 3])] /= 1.03
    prob.obs_uv[prob.obs_cam == 4] /= 0.98
    prob.refine_focal = True
    prob.focal_group = np.array([0, 1, 2, 2, 3])
    return prob, 40


def _long():
    rng = np.random.default_rng(8)
    return test_ba._long_track_problem(rng, 100, 12, cam_noise=0.003, pt_noise=0.01), 30


SCENES = {"noisy": _noisy, "reduces": _reduces, "focal": _focal, "shared": _shared,
          "long": _long}


def _max_dev(a, b):
    return [float(np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64)).max())
            for x, y in zip(a, b)]


def _rms(cost, prob):
    return np.sqrt(2 * cost / prob.obs_cam.shape[0])


@pytest.fixture(scope="module")
def jax_runs():
    """Per scene: the problem, JAX's result, and the control's largest
    deviation per output (R, t, fscale, points, rms)."""
    out = {}
    for name, make in SCENES.items():
        prob, iterations = make()
        ref = jax_ba.run_ba(prob, iterations=iterations)
        dev = np.zeros(5)
        for seed in CONTROL_SEEDS:
            other = jax_ba.run_ba(_perturbed(prob, seed), iterations=iterations)
            d = _max_dev(ref[:4], other[:4]) + [abs(_rms(ref[4], prob) - _rms(other[4], prob))]
            dev = np.maximum(dev, d)
        out[name] = (prob, iterations, ref, dev)
    return out


def test_so3_exp_both_branches():
    rng = np.random.default_rng(0)
    for scale in (0.3, 1e-5):  # above and below the |w|^2 = 1e-8 switch
        w = (rng.standard_normal((16, 3)) * scale).astype(np.float32)
        want = np.asarray(jax_ba.so3_exp(jnp.asarray(w)))
        got = ba.so3_exp(torch.from_numpy(w)).numpy()
        np.testing.assert_allclose(got, want, atol=2e-7)  # a few f32 ulps of 1


def _jax_args(prob, fscale=None):
    n_c = prob.R.shape[0]
    fs = np.zeros(n_c) if fscale is None else fscale
    return (jnp.asarray(prob.R), jnp.asarray(prob.t), jnp.asarray(fs, dtype=jnp.float32),
            jnp.asarray(prob.points), jnp.asarray(prob.obs_cam), jnp.asarray(prob.obs_pt),
            jnp.asarray(prob.obs_uv), jnp.asarray(prob.obs_focal))


def test_closed_form_jacobians_match_jacfwd():
    """Residuals, Jacobians and Huber weights against JAX's jacfwd, on the
    noisy scene with non-zero log-focal scales (so every column of the
    camera Jacobian is exercised) and a few observations past the Huber
    threshold."""
    prob, _ = _noisy()
    prob.obs_uv[::7] += 0.02  # ~20 px: outside HUBER_DELTA_PX
    fscale = np.array([0.0, 0.02, -0.03], np.float32)
    want = [np.asarray(x) for x in _jax_jacobians(*_jax_args(prob, fscale))]
    a = ba.problem_tensors(prob, "cpu")
    got = ba.obs_jacobians(a["R"], a["t"], torch.from_numpy(fscale), a["points"], a["obs_cam"],
                           a["obs_pt"], a["obs_uv"], a["obs_focal"])
    assert (want[3] < 1).sum() > 10
    # The residual (proj - uv) * focal cancels: a few f32 ulps of the
    # largest |uv| * focal.  A Huber weight 4 / |r| moves by at most
    # |d|r|| / 4 past the threshold.  The Jacobians: 1e-6 of their largest.
    r_atol = 4 * np.spacing(np.float32(np.abs(prob.obs_uv * prob.obs_focal[:, None]).max()))
    atols = [r_atol, 1e-6 * np.abs(want[1]).max(), 1e-6 * np.abs(want[2]).max(),
             np.sqrt(2) * r_atol / ba.HUBER_DELTA_PX]
    for w, g, atol in zip(want, got, atols):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol)


def _schur(prob, lam, tie=False, perturb_seed=None):
    """JAX's schur_step on ``prob`` (optionally perturbed) and the port's."""
    p = prob if perturb_seed is None else _perturbed(prob, perturb_seed)
    n_c, n_p = p.R.shape[0], p.points.shape[0]
    free = jax_ba._free_mask(p)
    idx, valid = jax_ba._group_by_point(p.obs_pt, n_p)
    T = jax_ba._tie_matrix(p.focal_group, free) if tie else None
    dc, dX = _jax_schur(
        *_jax_args(p)[:4], jnp.asarray(lam), *_jax_args(p)[4:], jnp.asarray(free),
        jnp.asarray(idx), jnp.asarray(valid), n_cameras=n_c,
        tie=None if T is None else jnp.asarray(T),
    )
    return np.asarray(dc), np.asarray(dX)


def _port_schur(prob, lam):
    a = ba.problem_tensors(prob, "cpu")
    dc, dX = ba.schur_step(
        a["R"], a["t"], a["fscale"], a["points"], torch.tensor(lam), a["obs_cam"], a["obs_pt"],
        a["obs_uv"], a["obs_focal"], a["free"], a["pt_obs_idx"], a["pt_obs_valid"],
        prob.R.shape[0], tie=a["tie"],
    )
    return dc.numpy(), dX.numpy()


@pytest.mark.parametrize("case", ["undamped", "damped", "tie"])
def test_schur_step_matches_jax(case):
    prob, _ = _shared() if case == "tie" else _noisy()
    if case != "tie":
        prob.refine_focal = False
    lam = 0.0 if case == "undamped" else 1e-3
    want = _schur(prob, lam, tie=case == "tie")
    control = np.max([_max_dev(want, _schur(prob, lam, case == "tie", s)) for s in CONTROL_SEEDS], 0)
    got = _port_schur(prob, lam)
    for w, g, c in zip(want, got, control):
        np.testing.assert_allclose(g, w, atol=CONTROL_FACTOR * c + ATOL_FLOOR)


def test_schur_point_chunks_equal_one_chunk(monkeypatch):
    """tests/test_ba.py's chunking case: 64 points in chunks of 16 against
    one chunk (the same products, summed over chunks in another order)."""
    prob = test_ba._long_track_problem(np.random.default_rng(17), 10, 64)
    one = _port_schur(prob, 1e-3)
    monkeypatch.setattr(ba, "POINT_CHUNK", 16)
    four = _port_schur(prob, 1e-3)
    for a, b in zip(one, four):
        np.testing.assert_allclose(b, a, atol=1e-6)  # as tests/test_ba.py's bound


@pytest.mark.parametrize("name", list(SCENES))
def test_run_ba_matches_jax_within_control(jax_runs, name):
    prob, iterations, ref, control = jax_runs[name]
    got = ba.run_ba(prob, iterations=iterations, device="cpu")
    dev = _max_dev(ref[:4], got[:4]) + [abs(_rms(ref[4], prob) - _rms(got[4], prob))]
    bound = CONTROL_FACTOR * control + ATOL_FLOOR
    assert (np.asarray(dev) <= bound).all(), (name, dev, bound.tolist())
    # Frozen parameters stay exactly where they were.
    np.testing.assert_array_equal(got[0][0], prob.R[0].astype(np.float32))
    if prob.focal_group is not None:
        assert got[2][2] == got[2][3]  # one shared scale


def test_results_do_not_depend_on_check_interval(monkeypatch):
    prob, iterations = _focal()
    a = ba.run_ba(prob, iterations=iterations, device="cpu")
    monkeypatch.setattr(ba, "CHECK_EVERY", 1)
    b = ba.run_ba(prob, iterations=iterations, device="cpu")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_host_helpers_equal_jax():
    prob, _ = _shared()
    np.testing.assert_array_equal(ba._free_mask(prob), jax_ba._free_mask(prob))
    fixed6 = np.zeros((5, 6), bool)
    fixed6[0] = True
    fixed6[1, 4] = True
    prob.fixed_cameras = fixed6
    free = ba._free_mask(prob)
    np.testing.assert_array_equal(free, jax_ba._free_mask(prob))
    np.testing.assert_array_equal(ba._tie_matrix(prob.focal_group, free),
                                  jax_ba._tie_matrix(prob.focal_group, free))
    for a, b in zip(ba._group_by_point(prob.obs_pt, 90), jax_ba._group_by_point(prob.obs_pt, 90)):
        np.testing.assert_array_equal(a, b)
