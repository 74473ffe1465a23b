"""Sparse stage-solver tests: symbolic LU, colored Jacobian, and
equivalence of the sparse and dense stiff integration paths on the
auto-generated kinase-cascade models (the reference's sparse-LU role:
src/utils/EigenPartialPivLUSomewhatSparse.h, LinearAlgebraSelector.h)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from bcm3_tpu.ode.sparse_lu import (
    SparseStageSolver,
    color_columns,
    detect_sparsity,
    symbolic_lu,
)


def _random_pattern(n, density, seed):
    rng = np.random.default_rng(seed)
    P = rng.random((n, n)) < density
    np.fill_diagonal(P, True)
    return P


def test_symbolic_lu_contains_pattern_and_fill():
    P = np.zeros((4, 4), dtype=bool)
    P[0, 3] = True
    P[3, 0] = True
    F = symbolic_lu(P)
    assert F.diagonal().all()
    assert F[0, 3] and F[3, 0]
    # no spurious fill for this arrow-free pattern
    assert F.sum() == 4 + 2


def test_symbolic_lu_fill_in():
    # eliminating column 0 with rows {1,2} below and cols {1,2} right
    # creates fill at (1,2), (2,1)
    P = np.zeros((3, 3), dtype=bool)
    P[1, 0] = P[2, 0] = P[0, 1] = P[0, 2] = True
    np.fill_diagonal(P, True)
    F = symbolic_lu(P)
    assert F[1, 2] and F[2, 1]


def test_color_columns_valid():
    P = _random_pattern(12, 0.25, 0)
    color_of, groups = color_columns(P)
    # every column colored exactly once
    assert sorted(j for g in groups for j in g) == list(range(12))
    # no two columns in a group share a row
    for g in groups:
        rows = [set(np.where(P[:, j])[0]) for j in g]
        for a in range(len(g)):
            for b in range(a + 1, len(g)):
                assert not (rows[a] & rows[b])


@pytest.mark.parametrize("n,density,seed", [(5, 0.4, 1), (12, 0.2, 2), (25, 0.12, 3)])
def test_sparse_factor_solve_matches_dense(n, density, seed):
    P = _random_pattern(n, density, seed)
    solver = SparseStageSolver(P)
    rng = np.random.default_rng(seed + 100)
    J = np.where(P, rng.normal(size=(n, n)), 0.0)
    inv_hg = 7.3
    G = inv_hg * np.eye(n) - J
    b = rng.normal(size=(n,))
    jac = {
        (int(i), int(j)): jnp.asarray(J[i, j]) for i, j in np.argwhere(P)
    }
    A = solver.factor_G(jac, jnp.asarray(inv_hg))
    x = np.asarray(solver.solve(A, jnp.asarray(b)))
    expected = np.linalg.solve(G, b)
    np.testing.assert_allclose(x, expected, rtol=1e-9, atol=1e-10)


def test_sparse_factor_solve_under_vmap():
    n = 9
    P = _random_pattern(n, 0.3, 7)
    solver = SparseStageSolver(P)
    rng = np.random.default_rng(8)
    B = 6
    Js = np.where(P[None], rng.normal(size=(B, n, n)), 0.0)
    bs = rng.normal(size=(B, n))
    inv_hg = 3.7

    def solve_one(Jflat, b):
        jac = {
            (int(i), int(j)): Jflat[k]
            for k, (i, j) in enumerate(np.argwhere(P))
        }
        A = solver.factor_G(jac, jnp.asarray(inv_hg))
        return solver.solve(A, b)

    nz = np.argwhere(P)
    Jflat = jnp.asarray(Js[:, nz[:, 0], nz[:, 1]])
    xs = jax.vmap(solve_one)(Jflat, jnp.asarray(bs))
    for bix in range(B):
        expected = np.linalg.solve(inv_hg * np.eye(n) - Js[bix], bs[bix])
        np.testing.assert_allclose(np.asarray(xs[bix]), expected, rtol=1e-8)


def _cascade_rhs_and_pattern(extra_modules):
    from bench_cellpop_scaling import cascade_model

    from bcm3_tpu.sbml import SBMLModel

    model = SBMLModel.from_string(cascade_model(extra_modules))
    rhs_core = model.make_rhs(["k_growth", "k_div"])
    const0 = jnp.asarray(model.initial_constant_values())
    params = jnp.asarray([0.1, 0.25])
    nsp = jnp.zeros(0)

    def fn(y):
        return rhs_core(0.0, y, const0, params, nsp)

    return model, fn


def test_structural_pattern_superset_of_numeric():
    model, fn = _cascade_rhs_and_pattern(3)
    P = model.jacobian_sparsity()
    n = model.num_ode_species
    rng = np.random.default_rng(0)
    ys = np.abs(rng.normal(0.5, 0.3, size=(5, n)))
    numeric = detect_sparsity(fn, ys)
    assert not (numeric & ~P).any(), "numeric pattern outside structural"


def test_colored_jacobian_matches_jacfwd():
    model, fn = _cascade_rhs_and_pattern(4)
    P = model.jacobian_sparsity()
    solver = SparseStageSolver(P)
    n = model.num_ode_species
    # cascades should color with a handful of colors regardless of size
    assert solver.num_colors <= 6
    y = jnp.asarray(np.abs(np.random.default_rng(1).normal(0.6, 0.2, n)))
    f0, entries = solver.jac_entries(fn, y)
    J = np.asarray(jax.jacfwd(fn)(y))
    np.testing.assert_allclose(np.asarray(f0), np.asarray(fn(y)), rtol=1e-12)
    for (i, j), v in entries.items():
        np.testing.assert_allclose(float(v), J[i, j], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("modules", [0, 8])
def test_stiff_solver_sparse_matches_dense(modules):
    from bcm3_tpu.ode.rosenbrock import solve_at_times_stiff

    model, fn = _cascade_rhs_and_pattern(modules)
    solver = SparseStageSolver(model.jacobian_sparsity())
    y0 = jnp.asarray(model.initial_ode_values())
    times = jnp.asarray(np.linspace(0.0, 2.0, 9))

    f = lambda t, y, args: fn(y)
    dense = solve_at_times_stiff(f, y0, times, rtol=1e-8, atol=1e-10)
    sparse = solve_at_times_stiff(
        f, y0, times, rtol=1e-8, atol=1e-10, sparse=solver
    )
    assert bool(dense.ok) and bool(sparse.ok)
    np.testing.assert_allclose(
        np.asarray(sparse.ys), np.asarray(dense.ys), rtol=2e-6, atol=1e-9
    )


def test_cellpop_logp_sparse_matches_dense(monkeypatch, tmp_path):
    """End-to-end: the 21-species dividing-cell likelihood evaluates to
    the same log-probability through the sparse and dense stage solvers
    (the solver swap must be numerically neutral at the tolerance the
    error controller enforces)."""
    from bench_cellpop_scaling import build_likelihood

    xs = jnp.asarray([[0.1, 0.25, 0.15, 0.05], [0.12, 0.22, 0.18, 0.06]])

    monkeypatch.setenv("BCM3_SPARSE_STIFF", "0")
    lik_dense = build_likelihood(8, 32, 4, matched=False)
    dense = np.asarray(jax.vmap(lik_dense.log_prob)(xs))

    monkeypatch.setenv("BCM3_SPARSE_STIFF", "1")
    lik_sparse = build_likelihood(8, 32, 4, matched=False)
    exp = lik_sparse.model.experiments[0]
    assert exp.sparse_solver is not None, "sparse path not engaged"
    sparse = np.asarray(jax.vmap(lik_sparse.log_prob)(xs))

    assert np.isfinite(dense).all()
    np.testing.assert_allclose(sparse, dense, rtol=5e-4)


def test_sharded_cellpop_sparse_matches_unsharded():
    """The sparse stage solver under mesh sharding: the 21-species
    cellpop likelihood evaluates identically with the batch axis sharded
    over the 8-device virtual mesh — multi-chip sharding of the chain
    batch is the scaling axis for reference-shaped cellpop workloads."""
    if jax.device_count() < 8:
        pytest.skip("needs an 8-device mesh")
    from bench_cellpop_scaling import build_likelihood

    from bcm3_tpu.parallel.mesh import chain_mesh, shard_leading_axis

    lik = build_likelihood(8, 16, 4, matched=False)
    assert lik.model.experiments[0].sparse_solver is not None
    rng = np.random.default_rng(4)
    base = np.array([0.1, 0.25, 0.15, 0.05])
    xs = jnp.asarray(base[None, :] * np.exp(
        0.05 * rng.normal(size=(16, 4))
    ))
    f = jax.jit(jax.vmap(lik.log_prob))
    unsharded = np.asarray(f(xs))
    assert np.isfinite(unsharded).all()

    mesh = chain_mesh(8)
    xs_sharded = shard_leading_axis(xs, mesh, 16)
    sharded = np.asarray(f(xs_sharded))
    np.testing.assert_allclose(sharded, unsharded, rtol=1e-12)


def test_singular_stage_matrix_fails_soft():
    """A structurally singular G must yield non-finite solve output
    (-> step rejection by the error controller), never silently wrong
    values: the no-pivot factorization's failure mode is 1/0 = inf."""
    P = np.zeros((3, 3), dtype=bool)
    P[0, 1] = P[1, 0] = True
    solver = SparseStageSolver(P)
    # J chosen so G = inv_hg*I - J has a zero pivot after elimination:
    # G = [[1, -2], [-2, 4]] block is singular
    jac = {
        (0, 0): jnp.asarray(0.0),
        (0, 1): jnp.asarray(2.0),
        (1, 0): jnp.asarray(2.0),
        (1, 1): jnp.asarray(-3.0),
        (2, 2): jnp.asarray(0.0),
    }
    A = solver.factor_G(jac, jnp.asarray(1.0))
    x = np.asarray(solver.solve(A, jnp.asarray([1.0, 1.0, 1.0])))
    assert not np.isfinite(x).all()
