"""Static-sparsity-pattern stage solver for batched stiff integration.

The JAX counterpart of the reference's sparsity-exploiting linear
algebra for stiff ODE models (reference:
src/utils/EigenPartialPivLUSomewhatSparse.h:1-108 — a partial-pivot LU
that skips structurally-zero columns, and the CVODE sparse backend
toggle, src/odecommon/LinearAlgebraSelector.h:1-33). Reaction-network
Jacobians touch few species per reaction, so the dense unrolled
masked-pivot LU in ode/rosenbrock.py (_small_lu) wastes O(S^2) masked
selects of O(S) vectors per elimination round — measured super-cubic
growth from 21 to 41 species (BASELINE.md species table).

Here the sparsity pattern is STATIC (fixed by the SBML reaction
structure), so everything symbolic happens once at
likelihood-construction time on the host:

- reverse Cuthill-McKee ordering to minimise fill-in (signalling
  cascades become narrow-band matrices);
- symbolic no-pivot LU on the boolean pattern, recording fill-in and a
  flat elimination schedule;
- greedy column coloring of the Jacobian pattern so the Jacobian is
  extracted with #colors JVPs instead of S (the role of the reference's
  generated per-entry Jacobian code, src/sbml/SBMLModel.h:28-30).

At trace time the factorization and triangular solves are emitted as
straight-line scalar arithmetic over ONLY the structurally nonzero
entries; under `vmap` every scalar op becomes a (batch,)-lane vector op
and XLA fuses the whole step into one kernel. No pivoting is performed:
the stage matrix G = I/(h*gamma) - J has the 1/(h*gamma) term on the
diagonal, which dominates whenever the error controller is keeping
steps stable; a near-singular pivot produces a large (or non-finite)
stage error and the step is rejected and retried with smaller h — the
same soft-fail path as a failed dense factorization (the reference's
CVODE likewise retries on linear-solver failure).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _rcm_order(pattern: np.ndarray) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of the symmetrised pattern."""
    try:
        import scipy.sparse as sp
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        sym = sp.csr_matrix((pattern | pattern.T).astype(np.int8))
        return np.asarray(
            reverse_cuthill_mckee(sym, symmetric_mode=True), dtype=np.int64
        )
    except Exception:  # pragma: no cover - scipy always present in image
        return np.arange(pattern.shape[0], dtype=np.int64)


def symbolic_lu(pattern: np.ndarray) -> np.ndarray:
    """Boolean LU fill pattern of a no-pivot factorization (diagonal
    forced nonzero). Standard symbolic Gaussian elimination."""
    F = np.asarray(pattern, dtype=bool).copy()
    n = F.shape[0]
    np.fill_diagonal(F, True)
    for k in range(n):
        below = np.where(F[k + 1 :, k])[0] + k + 1
        right = np.where(F[k, k + 1 :])[0] + k + 1
        if len(below) and len(right):
            F[np.ix_(below, right)] = True
    return F


def color_columns(pattern: np.ndarray) -> Tuple[np.ndarray, List[List[int]]]:
    """Greedy distance-2 coloring: columns sharing a nonzero row get
    different colors, so one JVP per color recovers exact entries
    (Curtis-Powell-Reid compressed Jacobian estimation)."""
    P = np.asarray(pattern, dtype=bool)
    n = P.shape[1]
    rows_of = [set(np.where(P[:, j])[0].tolist()) for j in range(n)]
    order = np.argsort([-len(r) for r in rows_of])
    color_of = -np.ones(n, dtype=np.int64)
    group_rows: List[set] = []
    groups: List[List[int]] = []
    for j in order:
        placed = False
        for c in range(len(groups)):
            if not (group_rows[c] & rows_of[j]):
                groups[c].append(int(j))
                group_rows[c] |= rows_of[j]
                color_of[j] = c
                placed = True
                break
        if not placed:
            groups.append([int(j)])
            group_rows.append(set(rows_of[j]))
            color_of[j] = len(groups) - 1
    return color_of, groups


class SparseStageSolver:
    """Precompiled sparse factor/solve for one fixed Jacobian pattern.

    Usage per Rosenbrock step (ode/rosenbrock.py):
        f0, J = solver.jac_entries(fn, y)       # colored JVPs
        A = solver.factor_G(J, inv_hg)          # LU of I*inv_hg - J
        x = solver.solve(A, rhs)                # (n,) -> (n,)
    """

    def __init__(self, jac_pattern: np.ndarray):
        P = np.asarray(jac_pattern, dtype=bool).copy()
        n = P.shape[0]
        np.fill_diagonal(P, True)  # G's diagonal is structurally nonzero
        self.n = n
        self.jac_pattern = P
        self.perm = _rcm_order(P)
        self.inv_perm = np.argsort(self.perm)
        Pp = P[np.ix_(self.perm, self.perm)]
        self.lu_pattern = symbolic_lu(Pp)
        self.fill_nnz = int(self.lu_pattern.sum())
        self.jac_nnz = int(P.sum())
        # Jacobian nonzeros in ORIGINAL index space (incl. diagonal)
        self.jac_nz = [tuple(ij) for ij in np.argwhere(P)]
        self.color_of, self.groups = color_columns(P)
        self.num_colors = len(self.groups)
        F = self.lu_pattern
        # elimination schedule (permuted index space)
        self._below = [
            (np.where(F[k + 1 :, k])[0] + k + 1).tolist() for k in range(n)
        ]
        self._right = [
            (np.where(F[k, k + 1 :])[0] + k + 1).tolist() for k in range(n)
        ]
        self._lrow = [
            np.where(F[i, :i])[0].tolist() for i in range(n)
        ]  # L part of row i
        self._urow = [
            (np.where(F[i, i + 1 :])[0] + i + 1).tolist() for i in range(n)
        ]  # strict U part of row i

    # ------------------------------------------------------------------
    # Jacobian extraction (colored JVPs)

    def jac_entries(self, fn: Callable, y) -> Tuple[jax.Array, Dict]:
        """``fn: y -> dy/dt``. Returns (fn(y), {(i,j): dfi/dyj}) with one
        linearization and ``num_colors`` linear applications — the
        compressed-Jacobian analogue of jax.jacfwd's n seeds."""
        n = self.n
        seeds = np.zeros((self.num_colors, n))
        for c, cols in enumerate(self.groups):
            seeds[c, cols] = 1.0
        f0, lin = jax.linearize(fn, y)
        jvs = jax.vmap(lin)(jnp.asarray(seeds, dtype=y.dtype))  # (C, n)
        entries = {
            (int(i), int(j)): jvs[int(self.color_of[j]), int(i)]
            for (i, j) in self.jac_nz
        }
        return f0, entries

    # ------------------------------------------------------------------
    # Factorization / solve (unrolled straight-line scalar code)

    def factor_G(self, jac: Dict, inv_hg) -> Dict:
        """LU of G = I*inv_hg - J in one pass. ``jac`` maps ORIGINAL
        (i, j) to scalars; returns factors keyed by PERMUTED (i, j).
        The stored diagonal holds 1/U_kk (multiplication is cheaper than
        repeated division in the four stage solves)."""
        n, F, perm = self.n, self.lu_pattern, self.perm
        A: Dict[Tuple[int, int], jax.Array] = {}
        zero = jnp.zeros((), dtype=inv_hg.dtype) if hasattr(inv_hg, "dtype") else 0.0
        for i in range(n):
            oi = int(perm[i])
            for j in ([i] + self._lrow[i] + self._urow[i]):
                oj = int(perm[j])
                v = jac.get((oi, oj))
                g = -v if v is not None else zero
                if i == j:
                    g = g + inv_hg
                A[(i, j)] = g
        for k in range(n):
            inv = 1.0 / A[(k, k)]
            A[(k, k)] = inv
            right = self._right[k]
            for i in self._below[k]:
                fmul = A[(i, k)] * inv
                A[(i, k)] = fmul
                for j in right:
                    A[(i, j)] = A[(i, j)] - fmul * A[(k, j)]
        return A

    def solve(self, A: Dict, b) -> jax.Array:
        """Solve G x = b with the factors from :meth:`factor_G`;
        ``b`` is (n,) in original index space, as is the result."""
        n, perm = self.n, self.perm
        x = [b[int(perm[i])] for i in range(n)]
        for i in range(n):
            for j in self._lrow[i]:
                x[i] = x[i] - A[(i, j)] * x[j]
        for i in range(n - 1, -1, -1):
            s = x[i]
            for j in self._urow[i]:
                s = s - A[(i, j)] * x[j]
            x[i] = s * A[(i, i)]
        out = [None] * n
        for i in range(n):
            out[int(perm[i])] = x[i]
        return jnp.stack(out)


def detect_sparsity(fn: Callable, y_samples: np.ndarray) -> np.ndarray:
    """Numerical Jacobian-pattern probe: union of |J| > 0 over sample
    points (used by tests to cross-check the structural pattern)."""
    P = None
    for y in np.asarray(y_samples):
        J = np.asarray(jax.jacfwd(fn)(jnp.asarray(y)))
        nz = np.abs(J) > 0
        P = nz if P is None else (P | nz)
    return P
