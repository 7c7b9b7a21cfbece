"""The port's multi-view solver (lfr_tpu_torch.solver) against lfr_tpu.solver.

Both packages get the same pairs, made from a seed by the port's
``synthetic.solver_graph`` with noise added to the flow grids (so the grids
are not constant and the LM's optimum is not at zero residual).  Host stages
(graph, tracks, packing) must give equal arrays and the partition equal
labels up to relabeling; the normal equations agree at 1e-5 of their largest
entry, positions at 1e-4 units, and on the noisy graphs every lane's
iteration count and ``done`` flag are equal (read through
``jax.vmap(lfr_tpu.solver.lm._lm_single)``).

Where a lane's cost reaches f32 rounding before an accepted step meets the
function tolerance (a zero-residual optimum, or a 2-node component solved
in two steps), the reference's stopping rule is decided by the last bits of
``new_cost < cost``: such a lane rejects steps until a rounding-level
decrease is accepted.  There the two packages agree in position and cost,
not in iteration count (``test_lm_at_the_f32_floor_agrees_in_position``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfr_tpu.io import protos as jax_protos
from lfr_tpu.solver import buckets as jax_buckets
from lfr_tpu.solver import graph as jax_graph
from lfr_tpu.solver import lm as jax_lm
from lfr_tpu.solver import partition as jax_partition
from lfr_tpu.solver import solve as jax_solve
from lfr_tpu.solver import tracks as jax_tracks
from lfr_tpu_torch.io import protos
from lfr_tpu_torch.solver import buckets, graph, lm, partition, solve, tracks
from lfr_tpu_torch.utils import synthetic

POS_ATOL = 1e-4
NE_RTOL = 1e-5
BATCH_FIELDS = ("edge_src", "edge_dst", "edge_sim", "edge_flow", "edge_intra", "edge_valid",
                "is_root", "node_valid")


def _noisy_pairs(seed, n_images, n_points, visibility, outlier_share, noise):
    pairs = synthetic.solver_graph(np.random.default_rng(seed), n_images, n_points,
                                   visibility, outlier_share)
    rng = np.random.default_rng(seed + 100)
    for p in pairs:
        p.disp1 = (p.disp1 + rng.normal(0.0, noise, p.disp1.shape)).astype(np.float32)
        p.disp2 = (p.disp2 + rng.normal(0.0, noise, p.disp2.shape)).astype(np.float32)
    return pairs


def _to_jax(pairs):
    return [jax_protos.PairMatches(p.image_name1, p.fact1, p.image_name2, p.fact2,
                                   p.matches, p.similarities, p.disp1, p.disp2)
            for p in pairs]


class Scene:
    """One graph through both packages' host stages."""

    def __init__(self, pairs):
        self.pairs = pairs
        self.jax_pairs = _to_jax(pairs)
        self.graph = graph.build_graph(pairs)
        self.jax_graph = jax_graph.build_graph(self.jax_pairs)
        self.tracks = tracks.build_tracks(self.graph)
        self.jax_tracks = jax_tracks.build_tracks(self.jax_graph, use_native=False)
        self.components = partition.partition_components(self.graph, self.tracks)
        self.stats = dict(partition.partition_stats)
        self.jax_components = jax_partition.partition_components(
            self.jax_graph, self.jax_tracks)
        self.jax_stats = dict(jax_partition.partition_stats)
        self.packed = buckets.pack_components(self.graph, self.tracks, self.components)


#: name -> (seed, images, points, visibility, outlier share, flow noise).
SCENES = {
    "no_outliers": (0, 5, 30, 0.7, 0.0, 0.3),
    "outliers": (0, 6, 60, 0.6, 0.1, 0.3),
    "many_tracks": (2, 8, 120, 0.6, 0.15, 0.3),
}


@functools.lru_cache(maxsize=None)
def _scene(name):
    return Scene(_noisy_pairs(*SCENES[name]))


# ---------------------------------------------------------------------------
# Host stages
# ---------------------------------------------------------------------------

GRAPH_FIELDS = ("image_facts", "node_image", "node_feature", "edge_src", "edge_dst",
                "edge_sim", "edge_flow", "match_src", "match_dst", "match_sim")


def _assert_graphs_equal(got, want):
    assert got.image_names == want.image_names
    for field in GRAPH_FIELDS:
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)


def _empty_pair(name1, name2):
    z = np.zeros((0, 3, 3, 2), np.float32)
    return protos.PairMatches(name1, 1.0, name2, 1.0, np.zeros((0, 2), np.uint32),
                              np.zeros(0, np.float32), z, z)


@pytest.mark.parametrize("case", ["outliers", "banned", "empty_pairs", "sparse_features",
                                  "all_banned"])
def test_build_graph_equals_jax(case):
    pairs = list(_scene("outliers").pairs)
    banned = None
    if case == "banned":
        banned = {"im002", "im004"}
    elif case == "empty_pairs":
        pairs = [_empty_pair("imx", "im000")] + pairs[:3] + [_empty_pair("im001", "imy")]
    elif case == "sparse_features":
        # A feature span large enough for the sort-based interning route.
        pairs = pairs[:4]
        pairs[1] = protos.PairMatches(**{**pairs[1].__dict__,
                                         "matches": pairs[1].matches + np.uint32(70_000_000)})
    elif case == "all_banned":
        banned = {"im000", "im001", "im002", "im003", "im004", "im005"}
    got = graph.build_graph(pairs, banned)
    _assert_graphs_equal(got, jax_graph.build_graph(_to_jax(pairs), banned))
    if case == "banned":
        assert not set(got.image_names) & banned and got.num_nodes > 0


@pytest.mark.parametrize("name", sorted(SCENES))
def test_build_tracks_equals_jax(name):
    scene = _scene(name)
    np.testing.assert_array_equal(scene.tracks.track_idx, scene.jax_tracks.track_idx)
    np.testing.assert_array_equal(scene.tracks.is_root, scene.jax_tracks.is_root)
    assert scene.tracks.num_tracks == scene.jax_tracks.num_tracks
    assert scene.tracks.max_track_size == scene.jax_tracks.max_track_size


def _same_partition(a, b):
    """Equal up to relabeling: the label pairs form a bijection."""
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_partition_equals_jax(name):
    scene = _scene(name)
    assert _same_partition(scene.components, scene.jax_components)
    assert scene.stats == scene.jax_stats


def test_partition_runs_eigsh_on_a_large_meta_component(monkeypatch):
    """The many_tracks graph cuts a meta-component of >= 32 tracks, so the
    Fiedler vector comes from ``eigsh`` (shift-invert), not the dense eigh."""
    import scipy.sparse.linalg

    scene = _scene("many_tracks")
    sizes = []
    real = scipy.sparse.linalg.eigsh

    def counting(a, *args, **kwargs):
        sizes.append(a.shape[0])
        return real(a, *args, **kwargs)

    monkeypatch.setattr(scipy.sparse.linalg, "eigsh", counting)
    labels = partition.partition_components(scene.graph, scene.tracks)
    stats = dict(partition.partition_stats)
    assert sizes and max(sizes) >= 32
    n_eigsh = len(sizes)
    want = jax_partition.partition_components(scene.jax_graph, scene.jax_tracks)
    assert len(sizes) == 2 * n_eigsh
    assert _same_partition(labels, want)
    assert stats == jax_partition.partition_stats and stats["cuts"] > 0


@pytest.mark.parametrize("caps", [(1 << 24, 1 << 18), (1 << 12, 1 << 9)])
def test_pack_components_equals_jax(caps):
    scene = _scene("outliers")
    got = buckets.pack_components(scene.graph, scene.tracks, scene.components, *caps)
    want = jax_buckets.pack_components(scene.jax_graph, scene.jax_tracks,
                                       scene.jax_components, *caps)
    assert len(got.batches) == len(want.batches) > 0
    for gb, wb, gm, wm in zip(got.batches, want.batches, got.node_maps, want.node_maps):
        np.testing.assert_array_equal(gm, wm)
        for field in BATCH_FIELDS:
            a, b = getattr(gb, field), getattr(wb, field)
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)
    if caps[0] < 1 << 24:
        assert len(got.batches) > len(buckets.pack_components(
            scene.graph, scene.tracks, scene.components).batches)


# ---------------------------------------------------------------------------
# LM primitives
# ---------------------------------------------------------------------------


def test_losses_match_jax():
    b_c, b_t = lm.CAUCHY_SCALE ** 2, lm.TUKEY_SCALE ** 2
    s = np.concatenate([np.linspace(0.0, 0.02, 201), [b_t, b_c, 1.0, 10.0]]).astype(np.float32)
    st, sj = torch.from_numpy(s), jnp.asarray(s)
    for name in ("cauchy_rho", "cauchy_weight", "tukey_rho", "tukey_weight"):
        got = getattr(lm, name)(st).numpy()
        want = np.asarray(getattr(jax_lm, name)(sj))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9, err_msg=name)


def _jax_arrays(batch):
    return tuple(jnp.asarray(getattr(batch, f)) for f in BATCH_FIELDS[:6])


def _free(batch):
    return batch.node_valid & ~batch.is_root


@pytest.mark.parametrize("name", ["outliers", "many_tracks"])
def test_cost_and_normal_equations_match_jax(name):
    rng = np.random.default_rng(7)
    for batch in _scene(name).packed.batches:
        x = rng.uniform(-0.7, 0.7, batch.is_root.shape + (2,)).astype(np.float32)
        arrays, free = lm.to_device(batch, "cpu")
        xt = torch.from_numpy(x)
        h, g = lm._normal_equations(xt, arrays, free)
        cost = lm._cost(xt, arrays)
        jarrays = _jax_arrays(batch)
        want_h, want_g = jax.vmap(jax_lm._normal_equations)(jnp.asarray(x), jarrays,
                                                            jnp.asarray(_free(batch)))
        want_cost = jax.vmap(jax_lm._cost)(jnp.asarray(x), jarrays)
        for got, want in ((h, want_h), (g, want_g), (cost, want_cost)):
            want = np.asarray(want)
            scale = np.abs(want).max()
            assert scale > 0
            np.testing.assert_allclose(got.numpy(), want, atol=NE_RTOL * scale, rtol=0)


@functools.lru_cache(maxsize=None)
def _jax_lm(max_iter):
    return jax.jit(jax.vmap(lambda x0, arrays, free: jax_lm._lm_single(x0, arrays, free,
                                                                       max_iter)))


def _run_both(batch, max_iter, x0):
    x, it, cost, done = _jax_lm(max_iter)(jnp.asarray(x0), _jax_arrays(batch),
                                          jnp.asarray(_free(batch)))
    arrays, free = lm.to_device(batch, "cpu")
    res = lm.lm_solve(arrays, free, torch.tensor(x0), max_iter=max_iter)
    return (np.asarray(x), np.asarray(it), np.asarray(cost), np.asarray(done)), res


#: Relative perturbations (of the flow grids, of the similarities) at the
#: scale of f32 rounding, under which a lane's count is checked for being
#: decided by the reference's own rounding.
ULP_PERTURBATIONS = tuple((1 + k * 2.0 ** -22, 1.0) for k in (-3, -2, -1, 1, 2, 3)) + (
    (1.0, 1 + 2.0 ** -22), (1.0, 1 - 2.0 ** -22))


#: Most lanes of one bucket whose count JAX's own rounding decides.  Measured
#: with ``_rounding_decided`` on the buckets compared below: 0, 0, 0 lanes
#: of "outliers" (17, 31, 11 lanes), 0, 1, 1 of "many_tracks" (78, 30, 8),
#: and 0 in both calls of the warm start.
MAX_ROUNDING_DECIDED_LANES = 1


def _rounding_decided(batch, max_iter, x0, it, done):
    """(B,) lanes whose JAX iteration count or done flag moves when the
    inputs move by f32 rounding: JAX itself does not determine them."""
    moved = np.zeros(batch.batch, dtype=bool)
    for flow_scale, sim_scale in ULP_PERTURBATIONS:
        arrays = list(_jax_arrays(batch))
        arrays[3] = arrays[3] * np.float32(flow_scale)
        arrays[2] = arrays[2] * np.float32(sim_scale)
        _, it_p, _, done_p = _jax_lm(max_iter)(jnp.asarray(x0), tuple(arrays),
                                               jnp.asarray(_free(batch)))
        moved |= (np.asarray(it_p) != it) | (np.asarray(done_p) != done)
    return moved


def _assert_lanes_match(batch, max_iter=100, x0=None):
    """Positions at POS_ATOL on every lane; iteration counts and done flags
    equal on every lane that JAX's own rounding does not decide; at most
    MAX_ROUNDING_DECIDED_LANES lanes decided by rounding.  Returns the JAX
    result and the port's."""
    if x0 is None:
        x0 = np.zeros(batch.is_root.shape + (2,), np.float32)
    (x, it, cost, done), res = _run_both(batch, max_iter, x0)
    lanes = batch.node_valid.any(axis=1)
    assert lanes.sum() > 0
    np.testing.assert_allclose(res.x.numpy(), x, atol=POS_ATOL, rtol=0)
    moved = _rounding_decided(batch, max_iter, x0, it, done)
    np.testing.assert_array_equal(res.iterations.numpy()[~moved], it[~moved])
    np.testing.assert_array_equal(res.done.numpy()[~moved], done[~moved])
    assert moved[lanes].sum() <= MAX_ROUNDING_DECIDED_LANES
    # Where the reference's rounding decides, both end at the same cost.
    np.testing.assert_allclose(res.cost.numpy()[moved], cost[moved], atol=1e-9, rtol=1e-4)
    return (x, it, cost, done), res


@pytest.mark.parametrize("name,k", [("outliers", 0), ("outliers", 1), ("outliers", 2),
                                    ("many_tracks", 0), ("many_tracks", 1), ("many_tracks", 2)])
def test_lm_matches_jax_per_bucket(name, k):
    batch = _scene(name).packed.batches[k]
    (x, it, cost, done), res = _assert_lanes_match(batch)
    assert it[batch.node_valid.any(axis=1)].max() > 1


def test_bucket_shapes_are_the_parametrized_ones():
    assert len(_scene("outliers").packed.batches) == 3
    assert len(_scene("many_tracks").packed.batches) == 3
    shapes = {(b.batch, b.n_nodes, b.n_edges) for name in ("outliers", "many_tracks")
              for b in _scene(name).packed.batches}
    assert max(n for _, n, _ in shapes) <= 16


def test_lm_warm_start_and_budget_match_jax():
    """A short budget then a warm restart, as the straggler path runs it."""
    batch = _scene("outliers").packed.batches[0]
    (x1, _, _, done1), _ = _assert_lanes_match(batch, max_iter=2)
    assert not done1[batch.node_valid.any(axis=1)].all()
    _assert_lanes_match(batch, max_iter=98, x0=x1)


def test_lm_failed_cholesky_lane_ends_as_in_jax():
    """Negative similarities in lane 0 make its damped system indefinite:
    JAX's factor is NaN, the step not finite, so the lane keeps x0 and ends
    after one step.  The port maps ``cholesky_ex``'s info to the same."""
    batch = _scene("outliers").packed.batches[0]
    fields = {f: getattr(batch, f).copy() for f in BATCH_FIELDS}
    fields["edge_sim"][0] *= -1.0
    bad = lm.ComponentBatch(**fields)
    x0 = np.full(bad.is_root.shape + (2,), 0.01, np.float32)
    (x, it, cost, done), res = _run_both(bad, 100, x0)
    assert done[0] and it[0] == 1 and np.array_equal(x[0], x0[0])
    np.testing.assert_array_equal(res.iterations.numpy(), it)
    np.testing.assert_array_equal(res.done.numpy(), done)
    np.testing.assert_array_equal(res.x.numpy()[0], x0[0])
    np.testing.assert_allclose(res.x.numpy(), x, atol=POS_ATOL, rtol=0)


def test_lm_at_the_f32_floor_agrees_in_position():
    """Constant flows: every lane's optimum is at zero residual, so lanes end
    at the f32 floor of their cost, where the count is decided by rounding.
    Positions agree on every lane, and lanes whose counts differ end at the
    same cost to f32 rounding."""
    scene = Scene(synthetic.solver_graph(np.random.default_rng(0), 6, 60, 0.6))
    for batch in scene.packed.batches:
        x0 = np.zeros(batch.is_root.shape + (2,), np.float32)
        (x, it, cost, done), res = _run_both(batch, 100, x0)
        np.testing.assert_allclose(res.x.numpy(), x, atol=POS_ATOL, rtol=0)
        differ = (res.iterations.numpy() != it) | (res.done.numpy() != done)
        np.testing.assert_allclose(res.cost.numpy()[differ], cost[differ], atol=1e-9, rtol=0)


def test_solve_batch_runs_from_zero():
    batch = _scene("outliers").packed.batches[1]
    (x, _, _, _), _ = _assert_lanes_match(batch)
    got = lm.solve_batch(batch, device="cpu")
    np.testing.assert_allclose(got, x, atol=POS_ATOL, rtol=0)
    staged, done = lm.solve_component_batch_staged(*lm.to_device(batch, "cpu"), max_iter=100)
    np.testing.assert_array_equal(staged.numpy(), got)


# ---------------------------------------------------------------------------
# solve.py: solve_matches, solve_file, the CLI
# ---------------------------------------------------------------------------


def _assert_solutions_close(got, want):
    assert [s.image_name for s in got] == [s.image_name for s in want]
    for a, b in zip(got, want):
        assert a.fact == b.fact
        np.testing.assert_array_equal(a.feature_indices, b.feature_indices)
        np.testing.assert_allclose(a.displacements, b.displacements, atol=POS_ATOL, rtol=0)


@pytest.fixture(scope="module")
def matches_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("solve") / "matches.pb"
    protos.write_matching_file(str(path), _scene("outliers").pairs)
    return str(path)


@pytest.fixture(scope="module")
def jax_solution(matches_file, tmp_path_factory):
    """``jax_solve.solve_file``'s body with ``use_mesh=False``: under
    tests/conftest.py's 8 virtual devices its default is the sharded path,
    which runs one 100-step phase.  The port's default without a process
    group is its two-phase path; tests/test_torch_parallel.py holds its
    sharded path against JAX's."""
    out = tmp_path_factory.mktemp("jax") / "solution.pb"
    pairs = jax_protos.read_matching_file(matches_file)
    solutions = jax_solve.solve_matches(pairs, use_mesh=False, verbose=False)
    jax_protos.write_solution_file(str(out), solutions)
    return protos.read_solution_file(str(out))


def test_solve_matches_equals_jax(jax_solution):
    spans = {}
    got = solve.solve_matches(_scene("outliers").pairs, device="cpu", verbose=False,
                              sub_spans=spans)
    _assert_solutions_close(got, jax_solution)
    for key in ("graph", "tracks", "partition", "pack", "lm_phase1", "lm_stragglers"):
        assert spans[key]["calls"] >= 1, key
    assert spans["n_nodes"] == _scene("outliers").graph.num_nodes
    assert spans["n_batches"] == 3 and spans["iterations_max"] > 1


def test_solve_file_and_cli_equal_jax(matches_file, jax_solution, tmp_path):
    out = tmp_path / "solution.pb"
    spans = {}
    solve.solve_file(matches_file, str(out), device="cpu", verbose=False, sub_spans=spans)
    _assert_solutions_close(protos.read_solution_file(str(out)), jax_solution)
    assert spans["read"]["calls"] == 1 and spans["write"]["calls"] == 1
    cli_out = tmp_path / "cli.pb"
    solve.main(["--matches_file", matches_file, "--output_file", str(cli_out),
                "--device", "cpu"])
    assert cli_out.read_bytes() == out.read_bytes()


def test_solve_with_banned_images_equals_jax():
    pairs = _scene("outliers").pairs
    banned = {"im001"}
    got = solve.solve_matches(pairs, banned, device="cpu", verbose=False)
    want = jax_solve.solve_matches(_to_jax(pairs), banned, use_mesh=False, verbose=False)
    _assert_solutions_close(got, want)
    assert "im001" not in [s.image_name for s in got]


def test_straggler_path_equals_jax(monkeypatch):
    monkeypatch.setattr(solve, "INITIAL_LM_ITER", 1)
    monkeypatch.setattr(jax_solve, "INITIAL_LM_ITER", 1)
    pairs = _scene("outliers").pairs
    spans = {}
    got = solve.solve_matches(pairs, device="cpu", verbose=False, sub_spans=spans)
    want = jax_solve.solve_matches(_to_jax(pairs), use_mesh=False, verbose=False)
    _assert_solutions_close(got, want)
    assert spans["n_stragglers"] > 0 and spans["lm_stragglers"]["total_s"] > 0


def test_cuda_device_raises_without_a_card(monkeypatch, matches_file, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pairs = _scene("no_outliers").pairs
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve.solve_matches(pairs, verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve.solve_file(matches_file, str(tmp_path / "s.pb"), verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.solve_batch(_scene("no_outliers").packed.batches[0])
    assert not (tmp_path / "s.pb").exists()
