"""The port's multi-rank layer (lfr_tpu_torch.parallel) against the JAX
package's sharded functions on tests/conftest.py's 8 virtual devices.

The ranks are CPU processes of one gloo process group, spawned twice per
module (4 ranks, then 2), one torch thread each.  They import no JAX: the
rank functions below run port code only, and the JAX references run in the
test process.  Shapes are tests/test_parallel.py's.

Tolerances, and why:

- Sharded solve: within ``SOLVE_ATOL`` = 1e-5 of JAX's ``sharded_solve_batch``
  (JAX's own bound against its single-device solve), and bit-equal to the
  port's world of one: the lanes are independent and every lane runs the
  same operations whatever its rank.
- Sharded BA: R within 1e-4, points within 1e-3, cost within rtol 1e-3 of
  JAX's ``run_ba_sharded`` (JAX's bounds against its single-device BA).
- Sharded train step (dp=2, mp=2): the loss within rtol 2e-3 of the port's
  single-rank step (tests/test_parallel.py's bound); the parameters, the
  head's gradient-free conv biases and the running statistics after one
  step as relative norms within ``CONTROL_FACTOR`` times the larger of two
  controls of the single-rank step (inputs scaled by 1 + 2e-7 N(0, 1);
  oneDNN off), as tests/test_torch_train.py holds the port against JAX:
  the split convs and the collectives sum in another order, and Adam's
  first step moves an entry by about lr times the sign of its gradient.
- ``solve_matches(use_mesh=True)``: within tests/test_torch_solver.py's
  1e-4 units of JAX's ``solve_matches(use_mesh=True)``.
- At a world of one every sharded function equals its unsharded form bit
  for bit.
"""

import numpy as np
import pytest
import torch

from lfr_tpu_torch import dryrun
from lfr_tpu_torch.models import checkpoint, panet, train
from lfr_tpu_torch.parallel import distributed, mesh as mesh_mod, multiprocess, sharded
from lfr_tpu_torch.sfm import ba
from lfr_tpu_torch.solver import lm, solve

SOLVE_ATOL = 1e-5
BA_R_ATOL = 1e-4
BA_X_ATOL = 1e-3
BA_COST_RTOL = 1e-3
LOSS_RTOL = 2e-3
CONTROL_FACTOR = 4.0
PERTURB = 2e-7
POS_ATOL = 1e-4
TRAIN_BATCH = 8
ZERO_GRAD = tuple(f"params/refine/conv{i}/bias" for i in range(4))


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        name = f"{prefix}/{key}" if prefix else key
        out.update(_flat(value, name) if isinstance(value, dict) else {name: np.asarray(value)})
    return out


def _component_batch(b=6):
    """tests/test_parallel.py:43's bucket."""
    rng = np.random.default_rng(1)
    flow = (0.2 * rng.standard_normal((b, 4, 3, 3, 2))).astype(np.float32)
    return lm.ComponentBatch(
        edge_src=np.zeros((b, 4), np.int32),
        edge_dst=np.tile(np.array([1, 2, 1, 2], np.int32), (b, 1)),
        edge_sim=np.ones((b, 4), np.float32),
        edge_flow=flow,
        edge_intra=np.ones((b, 4), bool),
        edge_valid=np.ones((b, 4), bool),
        is_root=np.tile(np.array([True, False, False]), (b, 1)),
        node_valid=np.ones((b, 3), bool),
    )


def _ba_problem():
    """tests/test_parallel.py:81's scene, as the port's BAProblem (the ranks
    unpickle it without importing the JAX package)."""
    import dataclasses

    import test_ba

    from lfr_tpu.utils import synthetic

    rng = np.random.default_rng(5)
    scene = synthetic.random_scene(rng, num_points=60, num_cameras=4)
    prob = test_ba._problem_from_scene(scene, rng, fix=(0, 1))
    return ba.BAProblem(**{f.name: getattr(prob, f.name) for f in dataclasses.fields(prob)})


def _variables():
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "weights" / "panet_holdout.msgpack"
    return checkpoint.load_variables(str(path))


def _solver_pairs():
    import test_torch_solver

    return test_torch_solver._noisy_pairs(*test_torch_solver.SCENES["outliers"])


# ---------------------------------------------------------------------------
# The ranks (port code only: spawned processes import this module).
# ---------------------------------------------------------------------------


def _four_ranks(variables, data, cb, prob):
    shapes = {"default": mesh_mod.make_mesh(device="cpu").shape,
              "dp2": mesh_mod.make_mesh(dp=2, device="cpu").shape,
              "mp2": mesh_mod.make_mesh(mp=2, device="cpu").shape}
    try:
        mesh_mod.make_mesh(dp=3, mp=2, device="cpu")
        shapes["bad_product_raises"] = False
    except AssertionError:
        shapes["bad_product_raises"] = True
    try:
        mesh_mod.make_mesh(2, device="cpu")
        shapes["partial_mesh_raises"] = False
    except ValueError:
        shapes["partial_mesh_raises"] = True
    mesh = mesh_mod.make_mesh(dp=2, mp=2, device="cpu")
    loss, after, grads = dryrun.sharded_train_once(mesh, variables, data)
    world = mesh_mod.make_mesh(device="cpu")
    return {"shapes": shapes, "loss": loss, "train": after, "grads": grads,
            "solve": sharded.sharded_solve_batch(cb, world, max_iter=25),
            "ba": sharded.run_ba_sharded(prob, world, iterations=25),
            "rows": multiprocess.local_rows(8)}


def _two_ranks(cb, prob, pairs, matches_file, solution_file):
    world = mesh_mod.make_mesh(device="cpu")
    spans = {}
    solutions = solve.solve_matches(pairs, device="cpu", verbose=False, sub_spans=spans)
    return {"solve": sharded.sharded_solve_batch(cb, world, max_iter=25),
            "ba": sharded.run_ba_sharded(prob, world, iterations=25),
            "solutions": [(s.image_name, s.fact, s.feature_indices, s.displacements)
                          for s in solutions], "spans": spans,
            "multichip": dryrun._multichip_rank(1, 2, 4, "cpu", matches_file, solution_file)}


@pytest.fixture(scope="module")
def four():
    data = dryrun.train_batch(TRAIN_BATCH)
    return multiprocess.run_ranks(
        _four_ranks, 4, args=(_variables(), data, _component_batch(), _ba_problem()),
        device="cpu")


@pytest.fixture(scope="module")
def solve_files(tmp_path_factory):
    from lfr_tpu_torch.io import protos

    root = tmp_path_factory.mktemp("parallel_solve")
    protos.write_matching_file(str(root / "matches.pb"), _solver_pairs())
    return str(root / "matches.pb"), str(root / "solution.pb")


@pytest.fixture(scope="module")
def two(solve_files):
    return multiprocess.run_ranks(
        _two_ranks, 2, args=(_component_batch(), _ba_problem(), _solver_pairs(), *solve_files),
        device="cpu")


# ---------------------------------------------------------------------------
# JAX references (the test process; conftest's 8 virtual devices).
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_solve():
    from lfr_tpu.parallel import mesh as jax_mesh
    from lfr_tpu.parallel import sharded as jax_sharded
    from lfr_tpu.solver import lm as jax_lm

    cb = _component_batch()
    jax_cb = jax_lm.ComponentBatch(**{k: getattr(cb, k) for k in sharded._BATCH_FIELDS})
    return jax_sharded.sharded_solve_batch(jax_cb, jax_mesh.make_mesh(8), max_iter=25)


@pytest.fixture(scope="module")
def jax_ba():
    from lfr_tpu.parallel import mesh as jax_mesh
    from lfr_tpu.parallel import sharded as jax_sharded

    return jax_sharded.run_ba_sharded(_ba_problem(), jax_mesh.make_mesh(8), iterations=25)


def _assert_ba_close(got, want):
    np.testing.assert_allclose(got[0], want[0], atol=BA_R_ATOL)
    np.testing.assert_allclose(got[3], want[3], atol=BA_X_ATOL)
    np.testing.assert_allclose(got[4], want[4], rtol=BA_COST_RTOL, atol=1e-6)


# ---------------------------------------------------------------------------
# The mesh and the backend rule.
# ---------------------------------------------------------------------------


def test_make_mesh_defaults_and_asserts(four):
    one = mesh_mod.make_mesh(device="cpu")
    assert one.shape == {"dp": 1, "mp": 1} and one.rank == 0 and one.backend is None
    assert mesh_mod.make_mesh(1, dp=1, mp=1, device="cpu").size == 1
    x = torch.ones(3)
    assert one.all_reduce(x) is x and one.all_gather(x) is x
    with pytest.raises(AssertionError, match="dp\\*mp"):
        mesh_mod.make_mesh(dp=2, device="cpu")
    with pytest.raises(ValueError, match="every rank"):
        mesh_mod.make_mesh(2, device="cpu")
    shapes = four[0]["shapes"]
    assert shapes["default"] == {"dp": 4, "mp": 1}
    assert shapes["dp2"] == {"dp": 2, "mp": 2} and shapes["mp2"] == {"dp": 2, "mp": 2}
    assert shapes["bad_product_raises"] and shapes["partial_mesh_raises"]
    assert [r["rows"] for r in four] == [(0, 2), (2, 4), (4, 6), (6, 8)]


def test_backend_rule_raises_where_nccl_cannot_run():
    assert distributed.choose_backend(2, "cpu") == "gloo"
    with pytest.raises(ValueError, match="nccl needs a CUDA card per rank"):
        distributed.choose_backend(2, "cpu", "nccl")
    with pytest.raises(ValueError, match="nccl needs a CUDA card per rank"):
        distributed.choose_backend(1, "cuda", "nccl")  # no card here
    with pytest.raises(ValueError, match="backend must be"):
        distributed.choose_backend(2, "cpu", "mpi")
    assert not distributed.initialize()  # no coordinator, no process group
    with pytest.raises(RuntimeError, match="device='cuda'"):
        mesh_mod.make_mesh()


def test_param_shardings_match_jax():
    import jax

    from lfr_tpu.parallel import mesh as jax_mesh

    variables = _variables()
    specs = _flat(jax.tree_util.tree_map(
        lambda s: tuple(s.spec), jax_mesh.param_shardings(jax_mesh.make_mesh(8, dp=4, mp=2),
                                                          variables),
        is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding)))
    sd = panet.PANet(torch.float32, folded=False).state_dict()
    sd.update(panet.from_jax_variables(variables))
    got = mesh_mod.param_shardings(mesh_mod.make_mesh(device="cpu"), sd)
    # JAX leaf -> torch key and the torch dim of each JAX dim.
    names = {"kernel": "weight", "bias": "bias", "scale": "weight", "mean": "running_mean",
             "var": "running_var"}
    seen = set()
    for path, spec in specs.items():
        spec = tuple(spec)
        parts = path.split("/")
        key = ".".join(parts[1:-1] + [names[parts[-1]]])
        perm = {4: (3, 2, 0, 1), 2: (1, 0), 1: (0,)}[sd[key].ndim]
        want = None
        if "mp" in spec:
            want = perm.index(spec.index("mp"))
        assert got[key] == want, (path, spec, got[key])
        seen.add(key)
    assert {k for k, d in got.items() if d is not None} <= seen
    assert got["predict.weight"] == 1 and got["refine.conv0.weight"] == 0
    assert got["backbone.conv1_1.weight"] is None and got["predict.bias"] is None


@pytest.mark.parametrize("shape, multiple, axis", [((6, 3), 8, 0), ((8, 2), 4, 0),
                                                   ((3, 5, 2), 4, 1), ((0, 2), 3, 0)])
def test_pad_to_multiple_matches_jax(shape, multiple, axis):
    from lfr_tpu.parallel import mesh as jax_mesh

    a = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape) + 1
    got, n = mesh_mod.pad_to_multiple(a, multiple, axis)
    want, m = jax_mesh.pad_to_multiple(a, multiple, axis)
    assert n == m and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# A world of one: the unsharded functions, bit for bit.
# ---------------------------------------------------------------------------


def _single_step(variables, data, mkldnn=True):
    """The unsharded step: (loss, variables after, gradients by name)."""
    with torch.backends.mkldnn.flags(enabled=mkldnn):
        model = train.load_model(variables, torch.float32, "cpu").train()
        optimizer, _ = train.make_optimizer(model, dryrun.TRAIN_LR)
        loss = float(train.train_step(model, optimizer, *(torch.from_numpy(x) for x in data)))
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    return loss, _flat(panet.to_jax_variables(model)), grads


def test_world_of_one_train_step_is_train_step():
    variables, data = _variables(), dryrun.train_batch(4, seed=3)
    loss, after, grads = dryrun.sharded_train_once(mesh_mod.make_mesh(1, device="cpu"),
                                                   variables, data)
    want_loss, want, want_grads = _single_step(variables, data)
    got = _flat(after)
    assert loss == want_loss and list(got) == list(want) and list(grads) == list(want_grads)
    for key in want:
        assert got[key].tobytes() == want[key].tobytes(), key
    for key in want_grads:
        assert grads[key].tobytes() == want_grads[key].tobytes(), key


def test_world_of_one_solve_and_ba_are_unsharded():
    one = mesh_mod.make_mesh(1, device="cpu")
    cb = _component_batch()
    assert sharded.sharded_solve_batch(cb, one, 25).tobytes() == \
        lm.solve_batch(cb, 25, device="cpu").tobytes()
    prob = _ba_problem()
    got = sharded.run_ba_sharded(prob, one, iterations=25)
    want = ba.run_ba(prob, iterations=25, device="cpu")
    for a, b in zip(got[:4], want[:4]):
        assert a.tobytes() == b.tobytes()
    assert got[4] == want[4]


def test_sharded_step_needs_the_sharded_model_and_its_optimizer():
    mesh = mesh_mod.make_mesh(device="cpu")
    model = train.load_model(_variables(), torch.float32, "cpu").train()
    optimizer, _ = train.make_optimizer(model, dryrun.TRAIN_LR)
    with pytest.raises(ValueError, match="shard_model"):
        sharded.make_sharded_train_step(model, optimizer, mesh)
    sharded.shard_model(model, mesh)
    with pytest.raises(ValueError, match="optimizer must hold"):
        sharded.make_sharded_train_step(model, optimizer, mesh)
    with pytest.raises(ValueError, match="unfolded"):
        sharded.shard_model(panet.PANet(torch.float32), mesh)


# ---------------------------------------------------------------------------
# Four ranks: dp=2 x mp=2 train step; solve and BA over the flat mesh.
# ---------------------------------------------------------------------------


def test_sharded_solve_four_ranks_pads_and_matches_jax(four, jax_solve):
    got = four[0]["solve"]
    assert got.shape == jax_solve.shape == (6, 3, 2)
    np.testing.assert_allclose(got, np.asarray(jax_solve), atol=SOLVE_ATOL)
    want = lm.solve_batch(_component_batch(), 25, device="cpu")
    for r in four:
        assert r["solve"].tobytes() == want.tobytes()


def test_sharded_ba_four_ranks_matches_jax(four, jax_ba):
    _assert_ba_close(four[0]["ba"], jax_ba)
    for r in four[1:]:
        for a, b in zip(r["ba"][:4], four[0]["ba"][:4]):
            assert a.tobytes() == b.tobytes()


def _grad_relative(a, b, keys):
    num = sum(float(np.sum((a[k].astype(np.float64) - b[k]) ** 2)) for k in keys)
    return (num / sum(float(np.sum(b[k].astype(np.float64) ** 2)) for k in keys)) ** 0.5


def test_sharded_train_step_dp2_mp2_matches_one_rank(four):
    """The gradients too: Adam's first step is about lr times the sign of a
    gradient, so a collective that scaled the gradients by mp (a sum where
    the backward must be the identity) would leave the parameters within
    the controls; the gradients, gathered over mp, would be off by order 1."""
    variables, data = _variables(), dryrun.train_batch(TRAIN_BATCH)
    rng = np.random.default_rng(7)
    perturbed = tuple((x * (1 + PERTURB * rng.standard_normal(x.shape))).astype(np.float32)
                      if i < 2 else x for i, x in enumerate(data))
    loss, want, want_grads = _single_step(variables, data)
    _, pert, pert_grads = _single_step(variables, perturbed)
    _, route, route_grads = _single_step(variables, data, mkldnn=False)
    grads = four[0]["grads"]
    assert list(grads) == list(want_grads)
    bias = [f"refine.conv{i}.bias" for i in range(4)]
    for keys in ([k for k in grads if k not in bias], bias):
        err = _grad_relative(grads, want_grads, keys)
        control = max(_grad_relative(pert_grads, want_grads, keys),
                      _grad_relative(route_grads, want_grads, keys))
        assert err <= CONTROL_FACTOR * control, (keys[0], err, control)
    got = _flat(four[0]["train"])
    assert list(got) == list(want)  # the gathered state in JAX's layout
    for key in got:
        assert got[key].shape == want[key].shape and got[key].dtype == np.float32, key
    assert len({r["loss"] for r in four}) == 1
    np.testing.assert_allclose(four[0]["loss"], loss, rtol=LOSS_RTOL)
    start = _flat(variables)

    def relative(a, b, keys):
        num = sum(float(np.sum((a[k].astype(np.float64) - b[k]) ** 2)) for k in keys)
        den = sum(float(np.sum((b[k].astype(np.float64) - start[k]) ** 2)) for k in keys)
        return (num / den) ** 0.5

    groups = {"params": [k for k in want if k.startswith("params") and k not in ZERO_GRAD],
              "zero_grad": list(ZERO_GRAD),
              "batch_stats": [k for k in want if k.startswith("batch_stats")]}
    for name, keys in groups.items():
        err = relative(got, want, keys)
        control = max(relative(pert, want, keys), relative(route, want, keys))
        assert err <= CONTROL_FACTOR * control, (name, err, control)


# ---------------------------------------------------------------------------
# Two ranks: solve, BA, and the solver's sharded route.
# ---------------------------------------------------------------------------


def test_sharded_solve_and_ba_two_ranks(two, jax_solve, jax_ba):
    want = lm.solve_batch(_component_batch(), 25, device="cpu")
    for r in two:
        assert r["solve"].tobytes() == want.tobytes()
    np.testing.assert_allclose(two[0]["solve"], np.asarray(jax_solve), atol=SOLVE_ATOL)
    _assert_ba_close(two[0]["ba"], jax_ba)
    for a, b in zip(two[1]["ba"][:4], two[0]["ba"][:4]):
        assert a.tobytes() == b.tobytes()


@pytest.fixture(scope="module")
def jax_mesh_solution():
    from lfr_tpu.solver import solve as jax_solve_mod
    from test_torch_solver import _to_jax

    return jax_solve_mod.solve_matches(_to_jax(_solver_pairs()), use_mesh=True, verbose=False)


def _assert_solutions_close(got, want):
    assert [s[0] for s in got] == [s.image_name for s in want]
    for (name, fact, features, disp), b in zip(got, want):
        assert fact == b.fact
        np.testing.assert_array_equal(features, b.feature_indices)
        np.testing.assert_allclose(disp, b.displacements, atol=POS_ATOL, rtol=0)


def test_solve_matches_use_mesh_two_ranks_matches_jax(two, jax_mesh_solution):
    """use_mesh defaults to the sharded route under a process group of two."""
    _assert_solutions_close(two[0]["solutions"], jax_mesh_solution)
    spans = two[0]["spans"]
    assert spans["mesh_size"] == 2 and spans["n_stragglers"] == 0
    assert spans["lm_sharded"]["calls"] == spans["n_batches"] >= 1
    for (_, _, fa, da), (_, _, fb, db) in zip(two[0]["solutions"], two[1]["solutions"]):
        assert fa.tobytes() == fb.tobytes() and da.tobytes() == db.tobytes()


def test_solve_matches_use_mesh_one_rank_matches_jax(jax_mesh_solution):
    spans = {}
    got = solve.solve_matches(_solver_pairs(), device="cpu", verbose=False, sub_spans=spans,
                              use_mesh=True)
    _assert_solutions_close([(s.image_name, s.fact, s.feature_indices, s.displacements)
                             for s in got], jax_mesh_solution)
    assert spans["mesh_size"] == 1 and "lm_phase1" not in spans


def test_multichip_dry_run_on_two_ranks(two, solve_files, jax_mesh_solution):
    """dryrun_multichip's rank at dp=1, mp=2 (the card's layout): its own
    gates passed; the ranks agree; its solve_file equals JAX's sharded
    solve."""
    from lfr_tpu_torch.io import protos

    reports = [r["multichip"] for r in two]
    assert [(r["dp"], r["mp"], r["backend"]) for r in reports] == [(1, 2, "gloo")] * 2
    assert reports[0]["train_loss"] == reports[1]["train_loss"]
    assert np.isfinite(reports[0]["train_loss_bf16"])
    assert reports[0]["solve_parity_max_abs"] < dryrun.PARITY_ATOL
    assert reports[0]["ba_parity_max_abs"] < dryrun.PARITY_ATOL and reports[0]["ba_cost"] > 0
    assert reports[0]["train_variables"] is not None and reports[1]["train_variables"] is None
    assert reports[0]["solve_file"]["sub_spans"]["mesh_size"] == 2
    _assert_solutions_close([(s.image_name, s.fact, s.feature_indices, s.displacements)
                             for s in protos.read_solution_file(solve_files[1])],
                            jax_mesh_solution)
