"""Nested-dissection multifrontal Cholesky of the port against the JAX
package.

- The symbolic phase (copied numpy code) gives an identical plan, identical
  Schur and forward-solve routes and identical index maps on the 4x4, 5x5
  and 6x6 grids of tests/test_ndchol.py and on an 18x18 grid.
- The numeric phase (assemble + factorize + solve, float64) reproduces the
  JAX package's solve at atol 1e-9 (the tolerance of tests/test_ndchol.py),
  also with frozen variables, and both match the dense solve.
- A front that is not positive definite factors to NaN instead of raising,
  which is what the LM loop's step rejection relies on.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import rome_tpu as R  # noqa: E402
from rome_tpu.graph.lower import lower as jax_lower  # noqa: E402
from rome_tpu.solvers import linearize as JL  # noqa: E402
from rome_tpu.solvers.sparse import (  # noqa: E402
    ndchol_assemble as j_assemble,
    ndchol_factorize as j_factorize,
    ndchol_solve as j_solve,
    symbolic_factor as j_symbolic,
)
from rome_tpu_torch.solvers.sparse import (  # noqa: E402
    ndchol_assemble,
    ndchol_factorize,
    ndchol_logdet,
    ndchol_solve,
    symbolic_factor,
)
from test_torch_helpers import grid_graph  # noqa: E402


def _specs(rows, cols, seed=0, frozen=()):
    with jax.enable_x64():
        ga = jax_lower(grid_graph(R, rows, cols, seed=seed, frozen=frozen), dtype=jnp.float64)
    dofs = {t: ga.manifolds[t].dof for t in ga.type_names}
    specs = [(b.vtypes, np.asarray(b.vslots)) for b in ga.batches]
    return ga, dofs, specs


@pytest.mark.parametrize("rows,cols,leaf", [(4, 4, 4), (5, 5, 4), (6, 6, 4), (18, 18, 16)])
def test_symbolic_is_identical(rows, cols, leaf):
    ga, dofs, specs = _specs(rows, cols)
    sj = j_symbolic(ga.type_names, ga.counts, dofs, specs, leaf=leaf)
    st = symbolic_factor(ga.type_names, ga.counts, dofs, specs, leaf=leaf)
    assert (st.D, st.E, st.nlev) == (sj.D, sj.E, sj.nlev)
    assert st.plan == sj.plan
    assert st.ea_pairs == sj.ea_pairs and st.fea_pairs == sj.fea_pairs
    assert st.stats == sj.stats
    assert sorted(st.arrs) == sorted(sj.arrs)
    for k, v in sj.arrs.items():
        assert st.arrs[k].dtype == v.dtype, k
        np.testing.assert_array_equal(st.arrs[k], v, err_msg=k)
    dev = st.device_arrs("cpu")
    for k, v in sj.arrs.items():
        np.testing.assert_array_equal(dev[k].numpy(), v, err_msg=k)
        assert dev[k].dtype == (torch.int64 if v.dtype.kind in "iu" else torch.float32)


@functools.lru_cache(maxsize=None)
def _inputs(rows, cols, lam, frozen=(), leaf=4, seed=0):
    """Scaled damped system of a grid, float64, built by the JAX package as
    tests/test_ndchol.py:_ndchol_factor does, plus both symbolic plans."""
    ga, dofs, specs = _specs(rows, cols, seed=seed, frozen=frozen)
    sym_j = j_symbolic(ga.type_names, ga.counts, dofs, specs, leaf=leaf)
    sym_t = symbolic_factor(ga.type_names, ga.counts, dofs, specs, leaf=leaf)
    with jax.enable_x64():
        rt = JL.runtime_state(ga)
        lins = JL.linearize_all(ga, ga.values0, rt)
        arrs = sym_j.device_arrs()
        vals = JL.normal_eq_entry_values(ga, lins, dtype=jnp.float64)
        fvec = JL.free_vector(ga, rt).astype(jnp.float64)
        diag_H = jnp.zeros(sym_j.D, jnp.float64).at[arrs["diag_dst"]].add(
            vals[arrs["diag_src"]] * fvec[arrs["diag_dst"]] ** 2
        )
        dv = 1.0 / jnp.sqrt(jnp.maximum(diag_H * (1.0 + lam), 1e-12))
        df = dv * fvec
        diag_add = fvec * (lam / (1.0 + lam)) + (1.0 - fvec)
        H, g = JL.dense_normal_eqs(ga, lins, dtype=jnp.float64, rt=rt)
        diag = jnp.maximum(jnp.diag(H), 1e-8)
        Hd = H + lam * jnp.diag(diag)
        d = 1.0 / jnp.sqrt(jnp.maximum(jnp.diag(Hd), 1e-12))
        b = -g * d
        x_dense = np.asarray(jnp.linalg.solve(Hd * d[:, None] * d[None, :], b))
    inputs = {k: np.asarray(v) for k, v in
              dict(vals=vals, df=df, diag_add=diag_add, b=b).items()}
    return ga, sym_j, sym_t, inputs, x_dense


def _jax_ndchol(sym, inp):
    """The JAX package's assemble + factorize + solve on the same inputs
    (jitted: its eager dispatch is slow on the CPU)."""
    with jax.enable_x64():
        def run(vals, df, diag_add, b, arrs):
            Ws = j_assemble(sym, arrs, vals, df, diag_add)
            Linvs, L21s, _ = j_factorize(sym, arrs, Ws)
            return Ws, j_solve(sym, arrs, Linvs, L21s, b)

        Ws, x = jax.jit(run)(
            *(jnp.asarray(inp[k]) for k in ("vals", "df", "diag_add", "b")),
            sym.device_arrs(),
        )
        return [np.asarray(W) for W in Ws], np.asarray(x)


@pytest.mark.parametrize(
    "rows,cols,frozen,lam",
    [(6, 6, (), 1e-4), (4, 4, ("x1", "x5"), 1e-3)],
)
def test_assemble_factorize_solve_match_jax(rows, cols, frozen, lam):
    ga, sym_j, sym, inp, x_dense = _inputs(rows, cols, lam, frozen=frozen)
    Ws_jax, x_jax = _jax_ndchol(sym_j, inp)
    arrs = sym.device_arrs("cpu")
    t = {k: torch.tensor(v) for k, v in inp.items()}
    Ws = ndchol_assemble(sym, arrs, t["vals"], t["df"], t["diag_add"])
    for a, w in zip(Ws, Ws_jax):
        np.testing.assert_allclose(a.numpy(), w, rtol=0, atol=1e-12)
    Linvs, L21s, L11s = ndchol_factorize(sym, arrs, Ws)
    x = ndchol_solve(sym, arrs, Linvs, L21s, t["b"]).numpy()
    np.testing.assert_allclose(x, x_jax, rtol=0, atol=1e-9)
    np.testing.assert_allclose(x, x_dense, rtol=0, atol=1e-9)
    # frozen slots: exactly zero update
    for lbl in frozen:
        s = ga.var_labels["Pose2"].index(lbl)
        assert np.all(x[3 * s: 3 * s + 3] == 0.0)
    assert np.isfinite(float(ndchol_logdet(sym, L11s)))


def test_float32_factor_preconditions_float64_system():
    """The solver's precision split: the f32 factor's solve is close to the
    f64 one (it only preconditions an f64 CG)."""
    _ga, _sj, sym, inp, x_dense = _inputs(6, 6, 1e-4)
    arrs = sym.device_arrs("cpu")
    t = {k: torch.tensor(v, dtype=torch.float32) for k, v in inp.items()}
    Ws = ndchol_assemble(sym, arrs, t["vals"], t["df"], t["diag_add"])
    Linvs, L21s, _ = ndchol_factorize(sym, arrs, Ws)
    x = ndchol_solve(sym, arrs, Linvs, L21s, t["b"])
    assert x.dtype == torch.float32
    rel = np.linalg.norm(x.double().numpy() - x_dense) / np.linalg.norm(x_dense)
    assert rel < 1e-3


def test_non_spd_front_gives_nan_not_exception():
    _ga, _sj, sym, inp, _xd = _inputs(4, 4, 1e-3, frozen=("x1", "x5"))
    arrs = sym.device_arrs("cpu")
    t = {k: torch.tensor(v) for k, v in inp.items()}
    # a strongly negative diagonal makes the fronts indefinite
    Ws = ndchol_assemble(sym, arrs, t["vals"], t["df"], t["diag_add"] - 10.0)
    Linvs, L21s, L11s = ndchol_factorize(sym, arrs, Ws)
    assert any(bool(torch.isnan(L).all()) for L in L11s if L is not None)
    x = ndchol_solve(sym, arrs, Linvs, L21s, t["b"])
    assert not bool(torch.isfinite(x).all())
